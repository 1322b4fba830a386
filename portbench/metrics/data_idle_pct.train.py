"""``data_idle_pct.train``: the share of the traced window in which the
device is idle while the training loop waits for its next batch,
``100 x |idle ∩ union of the prefetch.wait spans| / window``, in %: the
program's span around ``train/prefetch``'s wait on its queue, on the main
thread (idle and the spans as in ``issue_idle_pct.train``)."""

from pathlib import Path

from portbench.harness import load_module

MOVES = "train_audio_s_per_s"
_issue = load_module(Path(__file__).with_name("issue_idle_pct.train.py"),
                     "portbench_metric_issue_idle_pct_train")


def read(r):
    trace = r["trace"]
    waits = _issue.spans({"prefetch.wait"}, trace.t0, trace.t1)
    if not trace.ops or not waits:
        return None
    return 100.0 * _issue.idle_ns(trace, [(a, b) for _, _, a, b in waits]) / (trace.t1 - trace.t0)
