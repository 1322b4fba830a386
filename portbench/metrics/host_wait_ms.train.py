"""``host_wait_ms.train``: the mean time, in ms a step, that the training
loop waits for its next batch from ``train/prefetch`` (the family's batches
in the worker thread: DeepSpeech2's read and collated there by the recipe's
dataset, the Conformer's made in set-up; and the staging copy), from the
benchmark's span around the iterator's ``next`` over every step of the
window."""

MOVES = "train_audio_s_per_s"


def read(r):
    waits = r["spans"].get("next")
    return 1e3 * sum(waits) / len(waits) if waits else None
