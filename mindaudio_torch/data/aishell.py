"""AISHELL-1 preparation: the ``ID,duration,wav,transcript`` manifest CSV of
each split (the port's copy of ``mindaudio_tpu.data.aishell``, pinned to it
by ``tests/test_torch_data_copies.py``), the schema the Conformer recipe's
``dataset`` reads. The port downloads nothing: the openslr-33 archive is
fetched and unpacked by the caller, and ``prepare_aishell(download=True)``
raises.
"""

from __future__ import annotations

import csv
import glob
import logging
import os

from . import io

logger = logging.getLogger(__name__)

__all__ = ["load_transcripts", "save_aishell_info", "prepare_aishell"]

SPLITS = ("train", "dev", "test")


def load_transcripts(data_folder: str) -> dict:
    """utt-id -> transcript from aishell_transcript_v0.8.txt."""
    path = os.path.join(
        data_folder, "data_aishell", "transcript", "aishell_transcript_v0.8.txt"
    )
    table = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if parts:
                table[parts[0]] = " ".join(parts[1:])
    return table


def save_aishell_info(data_folder: str, save_folder: str):
    """Write {train,dev,test}.csv with ``ID,duration,wav,transcript`` rows."""
    transcripts = load_transcripts(data_folder)
    os.makedirs(save_folder, exist_ok=True)

    id_start = 0
    for split in SPLITS:
        out_csv = os.path.join(save_folder, f"{split}.csv")
        wavs = sorted(glob.glob(
            os.path.join(data_folder, "data_aishell", "wav", split, "*", "*.wav")
        ))
        if os.path.exists(out_csv):
            # resume: skip the write but keep advancing id_start, so a
            # regenerated later split gets IDs disjoint from earlier ones
            id_start += len(wavs)
            continue
        rows = []
        for i, wav in enumerate(wavs):
            utt = os.path.splitext(os.path.basename(wav))[0]
            if utt not in transcripts:
                continue
            signal, sr = io.read(wav)
            rows.append([id_start + i, str(signal.shape[0] / sr), wav,
                         transcripts[utt]])
        with open(out_csv, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["ID", "duration", "wav", "transcript"])
            w.writerows(rows)
        logger.info("%s: %d utterances", out_csv, len(rows))
        id_start += len(wavs)


def prepare_aishell(data_path: str, download: bool = False,
                    save_folder: str | None = None):
    """Write the split CSVs of an unpacked AISHELL-1 tree under ``data_path``
    into ``save_folder`` (default ``data_path``)."""
    if download:
        raise ValueError("prepare_aishell: the port downloads nothing; fetch and unpack "
                         "openslr-33 under data_path first")
    save_aishell_info(data_path, save_folder or data_path)
