"""The ``train`` driver: a family's recipe trained as its ``train.main``
trains it, the family's batches fed through ``train/prefetch``'s thread and
staged on a side stream (``ToDevice``), one step a batch, nothing read back
inside a step.

Set-up makes the corpus (``family.corpus``), builds the recipe's model,
optimizer and step with the seeded weights, and runs epoch 0 of the corpus, which holds every bucket
shape the window uses: its first three steps are the ones the reference
follows. The window then runs whole epochs until ``--seconds`` have passed,
and ends at a synchronise: ``train_audio_s_per_s`` is the unpadded audio of
every step in it over its wall time. With ``--trace 1`` one more epoch runs
under ``torch.profiler``.

``correct`` compares the program's first three steps with the reference's
(after the window, the program's state freed): the relative gap of each of
the three losses, and by the worst leaf the gap of the first gradient's
norm (the program's from AdamW's second moment after one step,
``sqrt(sum(nu) / (1 - b2))``) and of each leaf's change over the three
steps, and the same two gaps by the median leaf; leaves whose reference
gradient is under a thousandth of the median leaf's are left out. Where the
family names the model's output layer (``Trainer.output_module``), also
the gap of the first step's logits over the valid frames. A cell's
``limits`` name the numbers it compares.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time

import torch

from portbench.harness import Check, Spans, Trace, leaf_gaps

FIRST_STEPS = 3


def training_checks(program, reference, limits):
    """The numbers compared, with the cell's limits: each step's loss gap
    (relative); the first step's logit gap (``logit_gap``), where both
    sides read the logits; the first gradient's and the change's gaps by
    the worst leaf and by the median leaf (``harness.leaf_gaps``), over the
    leaves whose reference gradient is at least a thousandth of the median
    leaf's (a bias before a batch norm, or under a softmax, has a gradient
    of rounding noise alone). A number the cell gives no limit is not
    compared."""
    if len(program["losses"]) != len(reference["losses"]):
        raise ValueError(f"the program took {len(program['losses'])} steps, the reference "
                         f"{len(reference['losses'])}")
    gaps = {f"loss{k}_gap": abs(p - r) / abs(r)
            for k, (p, r) in enumerate(zip(program["losses"], reference["losses"]), 1)}
    grads = reference["grad_norms"]
    median = statistics.median(grads.values())
    moved = {n for n, g in grads.items() if g >= 1e-3 * median}
    for key, name in (("grad_norms", "grad"), ("change", "change")):
        leaves = leaf_gaps(program[key], reference[key], moved)
        gaps[f"{name}_gap"], gaps[f"{name}_median_gap"] = max(leaves), statistics.median(leaves)
    if "logits" in program and "logits" in reference:
        gaps["logit_gap"] = logit_gap(program["logits"], reference["logits"],
                                      reference["frames"])
    return [Check(name, value, limits[name]) for name, value in gaps.items() if name in limits]


def logit_gap(program, reference, frames):
    """``|p - r| / |r|`` over every valid frame of every row (``frames[b]``
    of row ``b``), in float64; an output of another shape reads infinite."""
    if program.shape != reference.shape:
        return float("inf")
    valid = torch.arange(reference.shape[1])[None, :] < frames.reshape(-1, 1)
    p, r = program.double()[valid], reference.double()[valid]
    return float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r))


class Run:
    """One run of a train cell on ``ctx.device``."""

    def __init__(self, ctx):
        from mindaudio_torch.train.prefetch import ToDevice, prefetch

        self.ctx, self.device = ctx, ctx.device
        fam = ctx.family
        self.corpus = fam.corpus(ctx.config, ctx.cell, ctx.seed, ctx.device, ctx.tmpdir)
        self.corpus_s = time.perf_counter() - ctx.t_start
        self.trainer = fam.Trainer(ctx.config, ctx.cell, self.corpus, ctx.seed, ctx.device)
        self.to_device = ToDevice(ctx.device)
        self.feed = prefetch(self.trainer.batches(), size=2, transform=self.to_device)

    def step(self, spans):
        """One step of the next batch: ``(seconds of audio, shape, loss)``,
        the loss a device scalar."""
        with spans("next"):
            _, audio_s, shape, staged = next(self.feed)
        with spans("step"):
            metrics = self.trainer.step(self.to_device.ready(staged))
        return audio_s, shape, metrics["loss"]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def first_steps(self, spans):
        """Steps 1-3, with what the comparison reads of them: returns a
        function that gives the readings (read once the window is over)."""
        opt = self.trainer.optimizer
        start = [p.detach().clone() for p in opt.params]
        output, logits = getattr(self.trainer, "output_module", None), []
        hook = output and output.register_forward_hook(
            lambda module, args, out: logits.append(out.detach().cpu().float()))
        losses = [self.step(spans)[2]]
        if hook:
            hook.remove()
        nu_sums = torch.stack(torch._foreach_norm(opt.moments()[1], 1))
        losses += [self.step(spans)[2] for _ in range(FIRST_STEPS - 1)]
        change = torch.stack(torch._foreach_norm(torch._foreach_sub(opt.params, start)))
        del start
        names, b2 = list(opt.names), opt.b2

        def readings():
            out = {"losses": [float(x) for x in losses],
                   "grad_norms": dict(zip(names, (nu_sums / (1.0 - b2)).sqrt().tolist())),
                   "change": dict(zip(names, change.tolist()))}
            if logits:
                out["logits"] = logits[0]
            return out

        return readings

    def close(self):
        """Stop the prefetch thread and free the program's state."""
        self.feed.close()
        del self.trainer, self.feed, self.to_device
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, **kw):
        """The reference's readings (TF32 off: plain float32 products)."""
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        ctx = self.ctx
        return ctx.family.reference_readings(ctx.config, ctx.cell, self.corpus, ctx.seed,
                                             self.device, **kw)


def run(ctx):
    t_build = time.perf_counter()
    r = Run(ctx)
    if r.trainer.steps_per_epoch < FIRST_STEPS:
        raise ValueError(f"an epoch of {r.trainer.steps_per_epoch} steps is shorter than the "
                         f"{FIRST_STEPS} the reference follows")
    spans = Spans()
    t_epoch0 = time.perf_counter()
    program = r.first_steps(spans)
    per_epoch = r.trainer.steps_per_epoch
    for _ in range(per_epoch - FIRST_STEPS):
        r.step(spans)
    r.sync()
    setup_s = time.perf_counter() - ctx.t_start

    spans, audio, losses = Spans(), 0.0, []
    t0 = time.perf_counter()
    epoch_s = []
    while not losses or time.perf_counter() - t0 < ctx.seconds:
        epoch_s.append(time.perf_counter())
        for _ in range(per_epoch):
            audio_s, _, loss = r.step(spans)
            audio += audio_s
            losses.append(loss)
    r.sync()
    window_s = time.perf_counter() - t0

    trace, traced = None, []
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile

        tspans = Spans(timeline=True)
        prof = None
        with profile(activities=[ProfilerActivity.CUDA]) if r.device.type == "cuda" else (
                contextlib.nullcontext()) as prof:
            with tspans("window"):
                for _ in range(per_epoch):
                    traced.append(r.step(tspans)[1])
                with tspans("sync"):
                    r.sync()
        trace = Trace(prof, tspans)

    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = ctx.memory_peak()
    r.close()
    t_ref = time.perf_counter()
    checks = training_checks(program(), r.reference(), ctx.cell["limits"])
    phases = {"setup_s": setup_s, "imports_s": t_build - ctx.t_start, "corpus_s": r.corpus_s,
              "built_s": t_epoch0 - ctx.t_start, "window_s": window_s, "steps": len(losses),
              "reference_s": time.perf_counter() - t_ref,
              "epoch_s": [round(b - a, 3) for a, b in zip(epoch_s, epoch_s[1:])],
              "next_ms": 1e3 * sum(spans.durations["next"]) / len(spans.durations["next"])}
    return {"attempted": len(losses), "failed": failed, "memory_peak_bytes": peak,
            "phases": phases,
            "metrics": {"train_audio_s_per_s": audio / window_s, "peak_mem_gib": peak / 2**30,
                        "setup_s": setup_s},
            "checks": checks, "trace": trace, "traced_steps": traced,
            "spans": spans.durations}
