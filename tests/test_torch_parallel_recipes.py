"""The Conformer recipe's parallel settings through its ``main()`` on two
gloo processes on the CPU (toy widths, two steps), each run then resumed
from its checkpoint on one process.

Each setting is the JAX recipe's: ``train.zero1_optimizer`` (data parallel
over the two ranks with the moments sharded), ``model.moe_experts`` (MoE
blocks, data parallel), ``train.mesh_model_axis 2`` (Megatron tensor
parallelism, with and without MoE experts split over the axis) and
``train.pipeline_stages 2`` (GPipe over the encoder blocks, four
microbatches). Both ranks must log the same losses (they are the global
batch's), the checkpoint must hold whole tensors (the shapes of a
one-process model), and one process must resume from it at the global step
and train on.
"""


import numpy as np
import pytest
import torch

from mindaudio_torch.recipes.conformer import compute_cmvn_stats, convergence_run
from mindaudio_torch.recipes.conformer import train as ttrain
from mindaudio_torch.train import checkpoint as tckpt
from torch_dist import run_ranks

torch.set_num_threads(1)

TOY = ["--model.d_model", "32", "--model.head_num", "2", "--model.ffn_dim", "64",
       "--model.num_encoder_layers", "2", "--model.num_decoder_layers", "1",
       "--optim.bf16", "false", "--data.batch_factor", "0.0625",  # B = 4, 227-frame bucket
       "--device", "cpu", "--train.log_every_steps", "1"]

SETTINGS = {
    "zero1": ["--train.zero1_optimizer", "true"],
    "moe": ["--model.moe_experts", "4"],
    "tensor_parallel": ["--train.mesh_model_axis", "2"],
    "moe_expert_parallel": ["--model.moe_experts", "4", "--train.mesh_model_axis", "2"],
    "pipeline": ["--train.pipeline_stages", "2"],
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cipher"))
    convergence_run.gen(root, n_train=24, n_dev=8, n_test=8, seed=1)
    compute_cmvn_stats.main(convergence_run._args(root, 0) + TOY)
    return root


def _argv(root, ckpt_dir, steps, *extra):
    return convergence_run._args(root, steps) + TOY + [
        "--train.ckpt_dir", ckpt_dir, "--train.resume", "false"] + list(extra)


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_setting_trains_on_two_ranks_and_resumes_on_one(corpus, tmp_path, name):
    ckpt_dir = str(tmp_path / "ckpt")
    argv = _argv(corpus, ckpt_dir, 2, *SETTINGS[name])
    outs = run_ranks(2, "torch_parallel_cases", "recipe_case",
                     ("mindaudio_torch.recipes.conformer.train", argv), timeout=300)
    for out in outs:
        assert (out["steps"], out["final_step"]) == (2, 2)
        assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    assert outs[0]["losses"] == outs[1]["losses"]  # the global batch's loss on both ranks
    assert tckpt.list_steps(ckpt_dir) == [2]

    # whole tensors: the shapes of the one-process model
    moe = ["--model.moe_experts", "4"] if "moe" in name else []
    cfg, _ = ttrain.parse_args(_argv(corpus, ckpt_dir, 3, *moe))
    tok = ttrain.build_tokenizer(cfg)
    plain = ttrain.build_model(cfg, tok.vocab_size, "cpu")
    saved = tckpt.restore_checkpoint(ckpt_dir)
    shapes = {k: tuple(p.shape) for k, p in plain.named_parameters()}
    assert {k: tuple(v.shape) for k, v in saved["params"].items()} == shapes
    for key in ("mu", "nu"):
        assert {k: tuple(v.shape) for k, v in saved["opt_state"][key].items()} == shapes

    resumed = ttrain.main(_argv(corpus, ckpt_dir, 4, *moe) + ["--train.resume", "true"])
    assert (resumed["start_step"], resumed["final_step"]) == (2, 4)
    assert tckpt.list_steps(ckpt_dir) == [2, 4]


def test_one_process_checkpoint_resumes_on_two_ranks(corpus, tmp_path):
    """The reverse direction: a checkpoint of one process resumes under
    ZeRO-1 on two ranks, at its global step, from its moments."""
    ckpt_dir = str(tmp_path / "ckpt")
    one = ttrain.main(_argv(corpus, ckpt_dir, 2))
    assert one["final_step"] == 2
    saved = tckpt.restore_checkpoint(ckpt_dir)
    outs = run_ranks(2, "torch_parallel_cases", "recipe_case",
                     ("mindaudio_torch.recipes.conformer.train",
                      _argv(corpus, ckpt_dir, 4, "--train.zero1_optimizer", "true",
                            "--train.resume", "true")), timeout=300)
    for out in outs:
        assert (out["start_step"], out["final_step"]) == (2, 4)
    resumed = tckpt.restore_checkpoint(ckpt_dir)
    assert int(resumed["opt_state"]["count"]) == int(saved["opt_state"]["count"]) + 2
    assert all(resumed["params"][k].shape == v.shape for k, v in saved["params"].items())
