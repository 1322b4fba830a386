"""LibriSpeech preparation: ``wav/`` + ``txt/`` per split and a JSON manifest
(the port's copy of ``mindaudio_tpu.data.librispeech``, pinned to it by
``tests/test_torch_ds2_recipe.py``).

Each split becomes a directory with ``wav/<utt>.{wav,flac}``,
``txt/<utt>.txt`` and ``libri_<split>_manifest.json`` holding ``{"data_path",
"samples": [{"wav_path", "txt_path"}]}``, the layout the DeepSpeech2 recipe
reads. The tarballs are fetched by the caller (OpenSLR resource 12); FLAC
transcoding is left to the caller too, and a tree of WAVs is laid out
directly.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tarfile
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = ["create_json_dict", "build_split", "LIBRI_SPEECH_TARBALLS"]

# the tarballs of each split, as the JAX package's URLs name them
LIBRI_SPEECH_TARBALLS = {
    "train": ["train-clean-100.tar.gz", "train-clean-360.tar.gz", "train-other-500.tar.gz"],
    "val": ["dev-clean.tar.gz", "dev-other.tar.gz"],
    "test_clean": ["test-clean.tar.gz"],
    "test_other": ["test-other.tar.gz"],
}


def _relayout_tree(extracted_root: str, split_dir: str, manifest: dict):
    """Move each ``<utt>.wav``/``.flac`` of an extracted tree into ``wav/``,
    write its line of the chapter's ``*.trans.txt`` as ``txt/<utt>.txt``, and
    list the pair in ``manifest["samples"]``."""
    wav_dir = os.path.join(split_dir, "wav")
    txt_dir = os.path.join(split_dir, "txt")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(txt_dir, exist_ok=True)
    for txt_path in sorted(Path(extracted_root).rglob("*.trans.txt")):
        base_dir = txt_path.parent
        with open(txt_path, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                utt, transcript = parts[0], " ".join(parts[1:])
                with open(os.path.join(txt_dir, utt + ".txt"), "w", encoding="utf-8") as tf:
                    tf.write(transcript)
                for ext in (".wav", ".flac"):
                    src = base_dir / (utt + ext)
                    if src.exists():
                        shutil.move(str(src), os.path.join(wav_dir, utt + ext))
                        manifest["samples"].append({
                            "wav_path": os.path.join("wav", utt + ext),
                            "txt_path": os.path.join("txt", utt + ".txt"),
                        })
                        break


def _write_manifest(split_dir: str, split: str, manifest: dict):
    out = os.path.join(split_dir, f"libri_{split}_manifest.json")
    Path(out).write_text(json.dumps(manifest), encoding="utf8")
    logger.info("%s: %d samples", out, len(manifest["samples"]))
    return out


def build_split(extracted_roots, split_dir: str, split: str):
    """Lay out the extracted trees ``extracted_roots`` (one per tarball) as
    the split ``split`` under ``split_dir`` and write its manifest; returns
    the manifest's path."""
    os.makedirs(split_dir, exist_ok=True)
    manifest = {"data_path": split_dir, "samples": []}
    for root in extracted_roots:
        _relayout_tree(root, split_dir, manifest)
    return _write_manifest(split_dir, split, manifest)


def create_json_dict(data_path: str, tarballs=None):
    """Extract the tarballs of each split (``{split: [file name]}``, default
    :data:`LIBRI_SPEECH_TARBALLS`) found in ``data_path`` and write its
    manifest; a split whose tarballs are missing gets an empty one."""
    tarballs = tarballs or LIBRI_SPEECH_TARBALLS
    for split, names in tarballs.items():
        split_dir = os.path.join(data_path, split)
        os.makedirs(split_dir, exist_ok=True)
        manifest = {"data_path": split_dir, "samples": []}
        for name in names:
            tarball = os.path.join(data_path, name)
            if not os.path.exists(tarball):
                continue
            with tarfile.open(tarball) as tar:
                tar.extractall(data_path, filter="data")
            extracted = os.path.join(data_path, "LibriSpeech")
            _relayout_tree(extracted, split_dir, manifest)
            shutil.rmtree(extracted, ignore_errors=True)
        _write_manifest(split_dir, split, manifest)
