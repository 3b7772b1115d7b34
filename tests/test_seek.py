"""Granule-exact seek tests (pre-roll, normalization, round trips)."""

import numpy as np
import pytest

import nvorbis_tpu as nv
from nvorbis_tpu.errors import SeekNotSupportedError

from conftest import fixture_path
from test_ogg import ForwardOnlyStream


def _full_decode(name):
    r = nv.VorbisReader(fixture_path(name), engine="oracle")
    pcm = r.read_all()
    ch = r.channels
    r.dispose()
    return pcm, ch


@pytest.mark.parametrize("name", ["2test.ogg", "3test.ogg"])
@pytest.mark.parametrize("frac", [0.0, 0.1, 0.5, 0.9])
def test_seek_matches_straight_decode(name, frac):
    full, ch = _full_decode(name)
    total = len(full) // ch
    pos = int(total * frac)

    r = nv.VorbisReader(fixture_path(name), engine="oracle")
    r.seek_to(pos)
    assert r.sample_position == pos
    want = full[pos * ch : (pos + 1000) * ch]
    got = np.zeros(len(want), dtype=np.float32)
    n = r.read_samples(got)
    assert n == len(want)
    np.testing.assert_array_equal(got, want)
    r.dispose()


def test_seek_back_and_forth():
    full, ch = _full_decode("3test.ogg")
    r = nv.VorbisReader(fixture_path("3test.ogg"), engine="oracle")
    for pos in [5000, 100, 200000, 12345, 0]:
        r.seek_to(pos)
        got = np.zeros(256 * ch, dtype=np.float32)
        n = r.read_samples(got)
        np.testing.assert_array_equal(
            got[:n], full[pos * ch : pos * ch + n], err_msg=f"pos={pos}"
        )
    r.dispose()


def test_seek_by_time_position():
    full, ch = _full_decode("3test.ogg")
    r = nv.VorbisReader(fixture_path("3test.ogg"), engine="oracle")
    r.time_position = 1.0
    assert r.sample_position == 44100
    got = np.zeros(100 * ch, dtype=np.float32)
    r.read_samples(got)
    np.testing.assert_array_equal(got, full[44100 * ch : 44200 * ch])
    r.dispose()


def test_seek_forward_only_raises():
    r = nv.VorbisReader(ForwardOnlyStream(fixture_path("1test.ogg")), engine="oracle")
    with pytest.raises(SeekNotSupportedError):
        r.seek_to(100)
    r.dispose()


def test_seek_past_end():
    r = nv.VorbisReader(fixture_path("1test.ogg"), engine="oracle")
    with pytest.raises(Exception):
        r.seek_to(10**9)
    r.dispose()


def test_seek_into_first_packet_of_granule_bug_page():
    """A page whose backward packet walk misses the previous page's granule
    by the libvorbis long/short accounting difference (-(long/4 - short/4))
    gets its packet granules shifted; a target inside its FIRST packet must
    roll forward from the shifted start too.  (Unshifted, the roll overran
    the packet and the next read never returned.)"""
    name = "issue6test.ogg"
    full, ch = _full_decode(name)
    r = nv.VorbisReader(fixture_path(name), engine="oracle")
    delta = r.total_samples - len(full) // ch  # granule over-claim (63)
    dec = r._stream_decoder
    prov = dec._packet_provider
    idx = prov._index
    hits = 0
    for page in range(idx.first_data_page_index + 1, idx.page_count):
        prev_gp, prev_len, first = prov._previous_page_info(
            page, dec._get_packet_granules)
        gps, end_gp, _ = prov._target_page_info(
            page, first, prev_len, dec._get_packet_granules)
        if end_gp - prev_gp >= 0 or prev_gp <= 0 or first:
            continue
        pos = prev_gp + (gps[0] - end_gp) - 1  # last sample of packet 0
        if pos - delta + 1000 > len(full) // ch:
            continue
        r.seek_to(pos)
        got = np.zeros(1000 * ch, dtype=np.float32)
        assert r.read_samples(got) == len(got)
        k = pos - delta
        np.testing.assert_array_equal(got, full[k * ch : (k + 1000) * ch])
        hits += 1
    r.dispose()
    assert hits  # the fixture has such pages
