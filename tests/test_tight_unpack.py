"""Tight per-bucket spectrum unpack (nvt_unpack_window_spec_ptr): the
host engine's mode-sorted chunks land in per-bucket buffers with tight
row strides.  Pins (a) bit-equality with the wide single-buffer lane on
clean streams, and (b) the bad-frame reconstruction fallback (a type-bit
corrupted packet forces ok=0, bucket prep bails, and the wide row space
is rebuilt from the tight buffers)."""

import io
import os
import struct

import numpy as np
import pytest

import nvorbis_tpu as nv
from nvorbis_tpu import native
from nvorbis_tpu.ogg.crc import crc32
from nvorbis_tpu.testgen.corpus import fixture_path
from nvorbis_tpu.testgen.ogg_writer import split_pages

pytestmark = pytest.mark.skipif(
    native.load() is None, reason="native library unavailable"
)

SRC = fixture_path("3test.ogg")


def _decode(blob, tight):
    old = os.environ.pop("NVT_NO_TIGHT_UNPACK", None)
    if not tight:
        os.environ["NVT_NO_TIGHT_UNPACK"] = "1"
    try:
        return nv.VorbisReader(io.BytesIO(blob), engine="host").read_all()
    finally:
        os.environ.pop("NVT_NO_TIGHT_UNPACK", None)
        if old is not None:
            os.environ["NVT_NO_TIGHT_UNPACK"] = old


def test_clean_stream_bit_equal():
    blob = open(SRC, "rb").read()
    a = _decode(blob, True)
    b = _decode(blob, False)
    assert len(a) == len(b) and np.array_equal(a, b)


def test_bad_frame_reconstruction_bit_equal():
    pages = list(split_pages(open(SRC, "rb").read()))
    pg = bytearray(pages[12])
    payload0 = 27 + pg[26]
    pg[payload0] |= 1  # audio packet -> header type bit: frame decodes ok=0
    pg[22:26] = b"\0\0\0\0"
    pg[22:26] = struct.pack("<I", crc32(bytes(pg)))
    pages[12] = bytes(pg)
    blob = b"".join(pages)
    a = _decode(blob, True)
    b = _decode(blob, False)
    assert len(a) == len(b) and np.array_equal(a, b)
    # and both stay within tolerance of the oracle on the same bytes
    c = nv.VorbisReader(io.BytesIO(blob), engine="oracle").read_all()
    assert len(c) == len(a)
    assert float(np.abs(a - c).max()) < 2e-6
