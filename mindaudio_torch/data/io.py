"""WAV I/O for the host-side data layer (the port's copy of
``mindaudio_tpu.data.io``: ``info``, ``read`` and ``write``, pinned to it by
``tests/test_torch_recipe_infra.py``).

RIFF and RIFX byte orders, PCM at any integer depth from 1 to 64 bits (odd
container sizes such as 24-bit are repacked left-justified into the smallest
integer type that holds them), IEEE float32/float64, and partial reads by
``offset``/``duration`` in seconds that seek to the requested bytes of the
data chunk. int16/int32 samples are normalized to [-1, 1) on read.
``write`` writes little-endian RIFF at the array's own sample width.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read", "write", "info"]

_PCM = 0x0001
_IEEE_FLOAT = 0x0003
_EXTENSIBLE = 0xFFFE


def _read_exact(f, n):
    b = f.read(n)
    if len(b) != n:
        raise ValueError("Unexpected end of file.")
    return b


def _parse_header(f):
    """Walk the RIFF chunk list up to (and including) the data chunk header.

    Returns (fmt_code, channels, rate, bits, block_align, data_start,
    data_size, big_endian). The file position is left at data_start.
    """
    magic = _read_exact(f, 4)
    if magic == b"RIFF":
        big = False
    elif magic == b"RIFX":
        big = True
    else:
        raise ValueError(
            f"File format {magic!r} not understood. Only 'RIFF' and 'RIFX' "
            "supported."
        )
    e = ">" if big else "<"
    _read_exact(f, 4)  # riff size; files in the wild lie — chunk-walk instead
    if _read_exact(f, 4) != b"WAVE":
        raise ValueError("Not a WAV file.")

    fmt_code = channels = rate = bits = block_align = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError("No data chunk found.")
        cid = hdr[:4]
        size = struct.unpack(e + "I", hdr[4:])[0]
        if cid == b"fmt ":
            if size < 16:
                raise ValueError(f"Malformed fmt chunk (size {size}).")
            body = _read_exact(f, size)
            fmt_code, channels, rate, _bps, block_align, bits = struct.unpack(
                e + "HHIIHH", body[:16]
            )
            if fmt_code == _EXTENSIBLE and size >= 26:
                # cbSize(2) valid_bits(2) channel_mask(4) subformat GUID —
                # the first two GUID bytes are the real format code
                fmt_code = struct.unpack(e + "H", body[24:26])[0]
            if size % 2:
                f.seek(1, 1)
        elif cid == b"data":
            if fmt_code is None:
                raise ValueError("No fmt chunk before data.")
            return fmt_code, channels, rate, bits, block_align, f.tell(), size, big
        else:
            f.seek(size + (size % 2), 1)


def info(file):
    """Header-only probe: ``(frames, rate, channels, bits)`` without reading
    audio data (O(header) — used by data pipelines that need lengths of many
    files, e.g. multi-process bucketing where every rank must agree on the
    batch's bucket shape without decoding other ranks' rows)."""
    own = not hasattr(file, "read")
    f = open(file, "rb") if own else file
    try:
        _, channels, rate, bits, block_align, _, data_size, _ = _parse_header(f)
        block = block_align or max(1, channels * ((bits + 7) // 8))
        return data_size // block, rate, channels, bits
    finally:
        if own:
            f.close()


def read(file, offset=0.0, duration=None):
    """Read a WAV file (seek-based; partial reads touch only what they need).

    Args:
        file: path or open binary file handle of a RIFF/RIFX WAV file.
        offset: start reading after this time (seconds).
        duration: only load up to this much audio (seconds). ``None`` reads
            to the end.

    Returns:
        (audio, samplerate): ``audio`` is float for int16/int32-containered
        PCM (normalized by 2**15 / 2**31; 24-bit data lands in an int32
        container left-justified and is therefore also normalized), and the raw dtype otherwise
        (float32/float64/uint8/int64 returned as stored). 1-D for mono,
        ``(num_samples, num_channels)`` otherwise.
    """
    own = not hasattr(file, "read")
    f = open(file, "rb") if own else file
    try:
        (fmt_code, channels, rate, bits, block_align,
         data_start, data_size, big) = _parse_header(f)
        e = ">" if big else "<"
        if channels == 0 or bits == 0:
            raise ValueError("Malformed fmt chunk (zero channels or bits).")
        bytes_per = block_align // channels if block_align else (bits + 7) // 8
        if bytes_per == 0:
            bytes_per = (bits + 7) // 8
        frame_bytes = bytes_per * channels
        n_frames = data_size // frame_bytes

        start = int(round(float(offset) * rate)) if offset else 0
        # clamp into [0, n_frames]: a negative offset must not seek into the
        # header bytes before the data chunk
        start = min(max(start, 0), n_frames)
        count = n_frames - start
        if duration is not None:
            # negative duration → empty read (f.read(negative) would read to
            # EOF), as an empty slice would
            count = min(count, max(int(round(float(duration) * rate)), 0))

        f.seek(data_start + start * frame_bytes)
        raw = f.read(count * frame_bytes)
        count = len(raw) // frame_bytes  # tolerate truncated files

        if fmt_code == _PCM:
            if 1 <= bits <= 8:
                data = np.frombuffer(raw, dtype="u1", count=count * channels)
            elif bytes_per in (3, 5, 6, 7):
                # left-justified repack into the smallest compatible int
                # (MSBs preserved, low pad bytes zero)
                itemsize = 4 if bytes_per == 3 else 8
                a = np.zeros((count * channels, itemsize), dtype="u1")
                src = np.frombuffer(raw, dtype="u1",
                                    count=count * channels * bytes_per)
                src = src.reshape(-1, bytes_per)
                if big:
                    a[:, :bytes_per] = src
                else:
                    a[:, -bytes_per:] = src
                data = a.view(f"{e}i{itemsize}").reshape(-1)
            elif bits <= 64:
                data = np.frombuffer(raw, dtype=f"{e}i{bytes_per}",
                                     count=count * channels)
            else:
                raise ValueError(
                    f"Unsupported bit depth: {bits}-bit integer data.")
        elif fmt_code == _IEEE_FLOAT:
            if bits in (32, 64):
                data = np.frombuffer(raw, dtype=f"{e}f{bytes_per}",
                                     count=count * channels)
            else:
                raise ValueError(
                    f"Unsupported bit depth: {bits}-bit float data.")
        else:
            raise ValueError(f"Unknown wave file format: {fmt_code:#06x}.")
    finally:
        if own:
            f.close()
        else:
            f.seek(0)

    # own, native-byte-order copy (a '>i2' view would miss the == int16
    # normalization checks below)
    data = np.asarray(data).astype(data.dtype.newbyteorder("="))
    if channels > 1:
        data = data.reshape(-1, channels)
    if data.dtype == np.int32:
        data = data / 2147483648.0
    elif data.dtype == np.int16:
        data = data / 32768.0
    return data, int(rate)


def write(file, data, sr):
    """Write a numpy array as an uncompressed little-endian RIFF WAV file.

    Args:
        file: output path or open binary file handle.
        data: 1-D (mono) or 2-D ``(num_samples, num_channels)`` array of
            integer or float samples. Float data is written as IEEE float
            (float16 upcast to float32), integers/uint8 as PCM at their
            itemsize.
        sr: sample rate in samples/sec.
    """
    data = np.asarray(data)
    if data.dtype in (np.float16,):
        data = data.astype(np.float32)
    kind = data.dtype.kind
    if kind not in "if" and not (kind == "u" and data.dtype.itemsize == 1):
        raise ValueError(f"Unsupported data type '{data.dtype}'")

    channels = 1 if data.ndim == 1 else data.shape[1]
    bit_depth = data.dtype.itemsize * 8
    fmt_code = _IEEE_FLOAT if kind == "f" else _PCM
    body = np.ascontiguousarray(data.astype(data.dtype.newbyteorder("<"))).tobytes()

    block_align = channels * (bit_depth // 8)
    fmt_body = struct.pack("<HHIIHH", fmt_code, channels, int(sr),
                           int(sr) * block_align, block_align, bit_depth)
    if fmt_code != _PCM:
        fmt_body += b"\x00\x00"  # cbSize for non-PCM

    header = b"WAVE"
    header += b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
    if fmt_code != _PCM:
        header += b"fact" + struct.pack("<II", 4, data.shape[0])
    header += b"data" + struct.pack("<I", len(body))
    if len(header) + len(body) > 0xFFFFFFFF:
        raise ValueError("Data exceeds wave file size limit")

    riff_size = struct.pack("<I", len(header) + len(body) + (len(body) % 2))

    own = not hasattr(file, "write")
    f = open(file, "wb") if own else file
    try:
        f.write(b"RIFF" + riff_size + header + body)
        if len(body) % 2:
            f.write(b"\x00")
    finally:
        if own:
            f.close()
        else:
            f.seek(0)
