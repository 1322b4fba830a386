"""The parallel layer over ``torch.distributed`` (port of
``mindaudio_tpu.parallel``): process groups over the mesh axes ``(data,
model, seq, pipe)``, the collectives GSPMD would insert written out with
their backward passes, the Megatron rule table and ZeRO-1 layout,
expert-parallel MoE, ring and Ulysses sequence parallelism, and a GPipe
pipeline. The names below are those the JAX package exports; they load on
first use, so that the model modules this layer builds on can import its
collectives.
"""

import importlib

_EXPORTS = {
    "mesh": ("barrier", "batch_sharding", "get_device_id", "get_device_num", "get_rank_id",
             "initialize_distributed", "make_mesh", "replicated", "shard_batch",
             "put_global_batch"),
    "moe": ("MoEFeedForward", "moe_capacity"),
    "pipeline": ("pipeline_apply", "pipeline_spmd", "stack_layer_params"),
    "ring_attention": ("ring_attention", "sequence_parallel_attention", "ulysses_attention"),
    "shardings": ("CONFORMER_TP_RULES", "infer_shardings", "state_shardings"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_WHERE[name]}", __name__), name)
