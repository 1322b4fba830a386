"""VoxCeleb1/2 preparation (the port's copy of ``mindaudio_tpu.data.voxceleb``,
pinned to it by ``tests/test_torch_ecapa_recipe.py``): train/dev CSVs of
fixed-duration chunks and enrol/test CSVs from the verification-pairs file,
in the ``ID,duration,wav,start,stop,spk_id`` schema that the ECAPA-TDNN
recipe reads. Host only; the split is shuffled with
``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import csv
import glob
import logging
import os

import numpy as np

from . import io

logger = logging.getLogger(__name__)

__all__ = ["prepare_voxceleb", "get_chunks", "get_utt_split_lists"]

VOX_TRAIN_CSV = "train.csv"
VOX_DEV_CSV = "dev.csv"
VOX_ENROL_CSV = "enrol.csv"
VOX_TEST_CSV = "test.csv"
SAMPLERATE = 16000


def get_chunks(seg_dur: float, audio_id: str, audio_duration: float):
    """Segment ids ``<utt>_<start>_<stop>`` covering the utterance
    (reference voxceleb.py:251)."""
    num_chunks = int(audio_duration / seg_dur)
    return [
        f"{audio_id}_{i * seg_dur}_{i * seg_dur + seg_dur}"
        for i in range(num_chunks)
    ]


def get_utt_split_lists(data_folders, split_ratio, verification_pairs_file,
                        split_speaker=False, seed=1234):
    """Train/dev split excluding verification-test speakers
    (reference voxceleb.py:191)."""
    rng = np.random.default_rng(seed)
    train_lst, dev_lst = [], []

    with open(verification_pairs_file, encoding="utf-8") as f:
        test_utts = {line.rstrip("\n").split(" ")[1] for line in f if line.strip()}
    test_speakers = {u.split("/")[0] for u in test_utts}

    for data_folder in data_folders:
        path = os.path.join(data_folder, "wav", "**", "*.wav")
        files = sorted(glob.glob(path, recursive=True))
        if split_speaker:
            by_spk = {}
            for f in files:
                spk = f.split(f"{os.sep}wav{os.sep}")[1].split(os.sep)[0]
                if spk not in test_speakers:
                    by_spk.setdefault(spk, []).append(f)
            spks = list(by_spk)
            rng.shuffle(spks)
            cut = int(0.01 * split_ratio[0] * len(spks))
            for s in spks[:cut]:
                train_lst.extend(by_spk[s])
            for s in spks[cut:]:
                dev_lst.extend(by_spk[s])
        else:
            keep = [f for f in files
                    if f.split(f"{os.sep}wav{os.sep}")[1].split(os.sep)[0]
                    not in test_speakers]
            keep = list(keep)
            rng.shuffle(keep)
            cut = int(0.01 * split_ratio[0] * len(keep))
            train_lst.extend(keep[:cut])
            dev_lst.extend(keep[cut:])
    return train_lst, dev_lst


def prepare_csv_file(seg_dur, wav_lst, csv_file, amp_th=0.0):
    """Chunked train/dev CSV (reference voxceleb.py:265): each row is one
    ``seg_dur``-second segment; near-silent segments dropped by ``amp_th``."""
    rows = []
    for wav in wav_lst:
        parts = wav.split(os.sep)[-3:]
        if len(parts) != 3:
            logger.info("malformed path: %s", wav)
            continue
        spk_id, sess_id, utt = parts
        audio_id = "--".join([spk_id, sess_id, os.path.splitext(utt)[0]])
        try:
            signal, sr = io.read(wav)
        except Exception as e:  # unreadable file: skip like the reference
            logger.info("skipping %s: %s", wav, e)
            continue
        if signal.ndim > 1:
            signal = signal[:, 0]
        duration = signal.shape[0] / sr
        for chunk in get_chunks(seg_dur, audio_id, duration):
            s, e = chunk.split("_")[-2:]
            start = int(float(s) * sr)
            stop = int(float(e) * sr)
            seg = np.asarray(signal[start:stop], dtype=np.float64)
            if amp_th and np.mean(np.abs(seg)) < amp_th:
                continue
            rows.append([chunk, str(seg_dur), wav, start, stop, spk_id])

    with open(csv_file, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["ID", "duration", "wav", "start", "stop", "spk_id"])
        w.writerows(rows)
    logger.info("%s: %d segments", csv_file, len(rows))


def prepare_csv_enrol_test(data_folder, save_folder, verification_pairs_file):
    """Enrol/test CSVs from the verification file (reference voxceleb.py:352)."""
    seen = {"enrol": set(), "test": set()}
    rows = {"enrol": [], "test": []}
    with open(verification_pairs_file, encoding="utf-8") as f:
        pairs = [line.split() for line in f if line.strip()]
    for _, enrol, test in pairs:
        for kind, rel in (("enrol", enrol), ("test", test)):
            if rel in seen[kind]:
                continue
            seen[kind].add(rel)
            wav = os.path.join(data_folder, "wav", rel)
            if not os.path.exists(wav):
                continue
            signal, sr = io.read(wav)
            utt_id = rel.replace("/", "--").rsplit(".", 1)[0]
            rows[kind].append([
                utt_id, str(signal.shape[0] / sr), wav, 0, signal.shape[0],
                rel.split("/")[0],
            ])
    for kind, csv_name in (("enrol", VOX_ENROL_CSV), ("test", VOX_TEST_CSV)):
        out = os.path.join(save_folder, csv_name)
        with open(out, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["ID", "duration", "wav", "start", "stop", "spk_id"])
            w.writerows(rows[kind])
        logger.info("%s: %d utts", out, len(rows[kind]))


def prepare_voxceleb(
    data_folder_path,
    save_folder_path,
    verification_pairs_file,
    splits=("train", "dev", "test"),
    split_ratio=(90, 10),
    seg_dur=3.0,
    skip_prep=False,
    amp_th=5e-04,
    split_speaker=False,
    seed=1234,
):
    """Build train/dev (chunked) and enrol/test CSVs (reference voxceleb.py:76)."""
    if skip_prep:
        return
    os.makedirs(save_folder_path, exist_ok=True)
    data_folders = (data_folder_path.split(",")
                    if "," in data_folder_path else [data_folder_path])

    if "train" in splits or "dev" in splits:
        train_lst, dev_lst = get_utt_split_lists(
            data_folders, split_ratio, verification_pairs_file,
            split_speaker, seed,
        )
        if "train" in splits:
            prepare_csv_file(seg_dur, train_lst,
                             os.path.join(save_folder_path, VOX_TRAIN_CSV),
                             amp_th)
        if "dev" in splits:
            prepare_csv_file(seg_dur, dev_lst,
                             os.path.join(save_folder_path, VOX_DEV_CSV),
                             amp_th)
    if "test" in splits:
        prepare_csv_enrol_test(data_folders[0], save_folder_path,
                               verification_pairs_file)
