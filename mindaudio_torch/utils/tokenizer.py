"""Character tokenizer and vocabulary (the port's copy of
``mindaudio_tpu.utils.tokenizer``, pinned to it by
``tests/test_torch_recipe_infra.py``).

The conformer recipe's ``lang_char.txt`` convention: id 0 = ``<blank>``
(CTC), id 1 = ``<unk>``, the characters in sorted order, and the last id =
``<sos/eos>``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

__all__ = ["CharTokenizer", "build_char_vocab"]


def build_char_vocab(transcripts: Iterable[str]) -> List[str]:
    """Sorted unique characters (whitespace stripped) from transcripts."""
    chars = set()
    for text in transcripts:
        for ch in text:
            if not ch.isspace():
                chars.add(ch)
    return sorted(chars)


class CharTokenizer:
    """``<blank>=0, <unk>=1, chars..., <sos/eos>=vocab-1`` char-level mapping."""

    def __init__(self, chars: List[str]):
        self._set(["<blank>", "<unk>"] + list(chars) + ["<sos/eos>"])

    def _set(self, symbols):
        self.symbols = symbols
        self.char2id: Dict[str, int] = {c: i for i, c in enumerate(symbols)}
        self.vocab_size = len(symbols)
        self.blank_id = 0
        self.unk_id = symbols.index("<unk>") if "<unk>" in symbols else 1
        self.sos = self.eos = self.vocab_size - 1

    @classmethod
    def from_transcripts(cls, transcripts: Iterable[str]) -> "CharTokenizer":
        return cls(build_char_vocab(transcripts))

    @classmethod
    def from_file(cls, path: str) -> "CharTokenizer":
        """Load a ``lang_char.txt`` (symbol [id] per line, ids implicit by order)."""
        with open(path, encoding="utf-8") as f:
            symbols = [line.split()[0] for line in f if line.split()]
        tok = cls.__new__(cls)
        tok._set(symbols)
        return tok

    def save(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            for i, s in enumerate(self.symbols):
                f.write(f"{s} {i}\n")

    def encode(self, text: str) -> List[int]:
        return [self.char2id.get(ch, self.unk_id) for ch in text if not ch.isspace()]

    def decode(self, ids: Iterable[int]) -> str:
        return "".join(
            self.symbols[i] for i in ids
            if 0 < i < self.vocab_size - 1 and self.symbols[i] != "<unk>"
        )
