"""Masks, batch helpers, decode drivers, the tokenizer and CMVN statistics
of the port."""

from . import cmvn, common, mask, recognize, tokenizer  # noqa: F401
from .common import (  # noqa: F401
    IGNORE_ID,
    add_sos_eos,
    pad_sequence,
    remove_duplicates_and_blank,
)
from .recognize import ASRInference  # noqa: F401
from .tokenizer import CharTokenizer  # noqa: F401
