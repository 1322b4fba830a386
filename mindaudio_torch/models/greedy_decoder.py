"""Greedy CTC character decoder with WER/CER helpers (the port's copy of
``mindaudio_tpu.models.greedy_decoder``, pinned to it by
``tests/test_torch_deepspeech2.py``).

The argmax belongs on the device, beside the forward; this class is the
host-side tail: repeat collapse, blank removal, string assembly and edit
distances, on anything ``np.asarray`` reads (a CPU tensor included).
"""

from __future__ import annotations

import numpy as np

from ..metric.wer import _edit_distance

__all__ = ["GreedyCTCDecoder", "MSGreedyDecoder"]


class GreedyCTCDecoder:
    """Decode argmax id paths to strings and score them.

    Args:
        labels: the characters of the ids (a list of one-character strings).
        blank_index: id of the CTC blank.
    """

    def __init__(self, labels, blank_index: int = 0):
        self.labels = list(labels)
        self.int_to_char = dict(enumerate(self.labels))
        self.blank_index = blank_index
        # an id past the labels when the set has no space
        self.space_index = self.labels.index(" ") if " " in self.labels else len(self.labels)

    def wer(self, s1: str, s2: str) -> int:
        """Word-level edit distance between two space-separated sentences."""
        return _edit_distance(s1.split(), s2.split())

    def cer(self, s1: str, s2: str) -> int:
        """Character-level edit distance, spaces removed."""
        return _edit_distance(list(s1.replace(" ", "")), list(s2.replace(" ", "")))

    def process_string(self, sequence, size, remove_repetitions: bool = False):
        """One id path of length ``size`` → ``(string, offsets)``, the offsets
        being the frames of the emitted characters."""
        chars, offsets = [], []
        seq = np.asarray(sequence)
        for i in range(int(size)):
            idx = int(seq[i])
            if idx == self.blank_index:
                continue
            if remove_repetitions and i != 0 and idx == int(seq[i - 1]):
                continue
            chars.append(" " if idx == self.space_index else self.int_to_char[idx])
            offsets.append(i)
        return "".join(chars), offsets

    def convert_to_strings(self, sequences, sizes=None, remove_repetitions=False,
                           return_offsets=False):
        """:meth:`process_string` over a batch: one best path an utterance."""
        strings, offsets = [], []
        for b, seq in enumerate(sequences):
            size = sizes[b] if sizes is not None else len(seq)
            s, off = self.process_string(seq, size, remove_repetitions)
            strings.append([s])
            offsets.append([off])
        if return_offsets:
            return strings, offsets
        return strings

    def decode(self, probs, sizes=None):
        """Greedy-decode ``(batch, time, vocab)`` scores with ``(batch,)``
        valid frame counts: ``(strings, offsets)``."""
        best = np.argmax(np.asarray(probs), axis=-1)
        sizes = None if sizes is None else np.asarray(sizes)
        return self.convert_to_strings(best, sizes, remove_repetitions=True,
                                       return_offsets=True)


# the reference's name
MSGreedyDecoder = GreedyCTCDecoder
