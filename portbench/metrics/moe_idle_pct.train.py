"""``moe_idle_pct.train``: the share of the traced window in which the
device is idle while the host is inside an MoE layer's forward,
``100 x |idle ∩ union of the moe.* spans| / window``, in %: the program's
spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
(``parallel/moe``), on the main thread (idle and the spans as in
``issue_idle_pct.train``)."""

from pathlib import Path

from portbench.harness import load_module

MOVES = "train_audio_s_per_s"
SPANS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
_issue = load_module(Path(__file__).with_name("issue_idle_pct.train.py"),
                     "portbench_metric_issue_idle_pct_train")


def read(r):
    trace = r["trace"]
    found = _issue.spans(SPANS, trace.t0, trace.t1)
    if not trace.ops or not found:
        return None
    return 100.0 * _issue.idle_ns(trace, [(a, b) for _, _, a, b in found]) / (trace.t1 - trace.t0)
