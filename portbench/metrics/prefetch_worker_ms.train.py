"""``prefetch_worker_ms.train``: the mean time, in ms a batch, that
``train/prefetch``'s worker thread spends on a batch, from the program's
spans: ``prefetch.produce`` (the iterator's ``next``: DeepSpeech2's WAV reads
and collate) plus the ``prefetch.stage`` that follows it in the same thread
(``ToDevice``: host tensors, pinning, the copies' issue), over the batches
whose ``prefetch.produce`` starts in the traced window."""

from pathlib import Path

from portbench.harness import load_module

MOVES = "train_audio_s_per_s"
_issue = load_module(Path(__file__).with_name("issue_idle_pct.train.py"),
                     "portbench_metric_issue_idle_pct_train")


def read(r):
    trace = r["trace"]
    found = sorted(_issue.spans({"prefetch.produce", "prefetch.stage"}, trace.t0, main=False),
                   key=lambda s: (s[1], s[2]))
    batches = []
    for i, (name, thread, a, b) in enumerate(found):
        if name == "prefetch.produce" and trace.t0 <= a < trace.t1:
            stage = found[i + 1] if i + 1 < len(found) else None
            if stage and stage[0] == "prefetch.stage" and stage[1] == thread:
                b += stage[3] - stage[2]
            batches.append(b - a)
    if not trace.ops or not batches:
        return None
    return sum(batches) / len(batches) / 1e6
