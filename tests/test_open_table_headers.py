"""The open path's table-backed header parse (stream_decoder.
_try_table_headers): comment+setup come from the C++ packetization and the
provider's position catches up lazily (PacketProvider.fast_forward_packets).

Reference behavior anchored: StreamDecoder.ProcessHeaderPackets
(NVorbis/StreamDecoder.cs:107-127) consumes exactly the three header
packets before the first audio packet; these tests pin that the fast lane
is observably identical to the provider walk.
"""

import os

import numpy as np
import pytest

import nvorbis_tpu as nv
from nvorbis_tpu.testgen.corpus import fixture_path


def _with_lane(path, enabled, fn):
    old = os.environ.get("NVT_OPEN_TABLE_BYTES")
    os.environ["NVT_OPEN_TABLE_BYTES"] = str(4 << 20) if enabled else "0"
    try:
        r = nv.VorbisReader(path)
        try:
            return fn(r)
        finally:
            r.dispose()
    finally:
        if old is None:
            del os.environ["NVT_OPEN_TABLE_BYTES"]
        else:
            os.environ["NVT_OPEN_TABLE_BYTES"] = old


@pytest.mark.parametrize("name", ["1test.ogg", "3test.ogg"])
def test_headers_and_decode_identical(name):
    p = fixture_path(name)

    def grab(r):
        pcm = r.read_all()
        st = r.streams[0].stats
        return (
            r.channels, r.sample_rate, r.tags.encoder_vendor,
            tuple(sorted(r.tags.all.keys())), pcm,
            (st.overhead_bits, st.container_bits, st.audio_bits,
             st.waste_bits, st.packet_count),
        )

    fast = _with_lane(p, True, grab)
    slow = _with_lane(p, False, grab)
    assert fast[:4] == slow[:4]
    assert len(fast[4]) == len(slow[4])
    assert np.array_equal(fast[4], slow[4])
    # stats must count the header packets identically (bit-for-bit)
    assert fast[5] == slow[5]


def test_table_cached_on_decoder():
    r = nv.VorbisReader(fixture_path("1test.ogg"))
    dec = r._stream_decoder
    tbl = getattr(dec, "_pkt_table", None)
    assert isinstance(tbl, tuple) and len(tbl) == 5  # (data,off,gran,flags,ovh)
    # the decode reuses the cached table: table_for_decoder must return
    # the same object, not a rebuilt one
    from nvorbis_tpu.ogg.fast_packets import table_for_decoder

    assert table_for_decoder(dec) is tbl
    pcm = r.read_all()
    assert len(pcm) > 0
    r.dispose()


def test_streaming_after_table_open_starts_at_audio():
    """First streaming read drains the deferred skip: output equals the
    provider-path decode from sample 0."""
    p = fixture_path("3test.ogg")

    def stream_first(r):
        buf = np.zeros(8192, np.float32)
        n = r.read_samples(buf)
        return buf[:n].copy()

    fast = _with_lane(p, True, stream_first)
    slow = _with_lane(p, False, stream_first)
    assert np.array_equal(fast, slow)


def test_seek_after_table_open():
    """An absolute reposition cancels the deferred skip (seek_to path)."""
    p = fixture_path("3test.ogg")

    def seek_read(r):
        r.time_position = 2.0
        buf = np.zeros(4096, np.float32)
        n = r.read_samples(buf)
        return buf[:n].copy()

    fast = _with_lane(p, True, seek_read)
    slow = _with_lane(p, False, seek_read)
    assert np.array_equal(fast, slow)
