"""End-to-end oracle decode of the reference fixtures."""

import io

import numpy as np
import pytest

import nvorbis_tpu as nv

from conftest import fixture_path
from test_ogg import ForwardOnlyStream

# (channels, sample_rate, total_samples, decoded_samples)
EXPECTED = {
    # decoded counts as libvorbisfile reads them (tools/make_corpus.py
    # --check); total = the last page's granule
    "1test.ogg": (1, 44100, 17640, 17640),
    "2test.ogg": (1, 44100, 308700, 308700),
    "3test.ogg": (2, 44100, 286650, 286650),
    # issue6test's page granules claim 63 samples more than its packets hold
    "issue6test.ogg": (2, 44100, 548226, 548163),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_decode_fixture(name):
    channels, rate, total, decoded = EXPECTED[name]
    r = nv.VorbisReader(fixture_path(name), engine="oracle")
    assert r.channels == channels
    assert r.sample_rate == rate
    assert r.total_samples == total
    pcm = r.read_all()
    assert len(pcm) == decoded * channels
    assert np.all(np.isfinite(pcm))
    assert np.max(np.abs(pcm)) <= np.float32(0.99999994)
    # sane audio energy
    assert 1e-4 < float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2))) < 1.0
    r.dispose()


def test_decode_forward_only_matches_seekable():
    name = "3test.ogg"
    r1 = nv.VorbisReader(fixture_path(name), engine="oracle")
    pcm1 = r1.read_all()
    r1.dispose()
    r2 = nv.VorbisReader(ForwardOnlyStream(fixture_path(name)), engine="oracle")
    pcm2 = r2.read_all()
    r2.dispose()
    assert len(pcm1) == len(pcm2)
    np.testing.assert_array_equal(pcm1, pcm2)


def test_decode_from_bytes_and_stream():
    raw = open(fixture_path("1test.ogg"), "rb").read()
    pcm_a = nv.VorbisReader(raw, engine="oracle").read_all()
    pcm_b = nv.VorbisReader(io.BytesIO(raw), engine="oracle").read_all()
    np.testing.assert_array_equal(pcm_a, pcm_b)


def test_clipping_flag():
    r = nv.VorbisReader(fixture_path("3test.ogg"), engine="oracle")
    r.read_all()
    assert r.has_clipped  # 3test contains samples beyond the clip point
    r.dispose()

    r = nv.VorbisReader(fixture_path("3test.ogg"), engine="oracle")
    r.clip_samples = False
    pcm = r.read_all()
    assert not r.has_clipped
    assert float(np.max(np.abs(pcm))) > 0.99999994
    r.dispose()


def test_tags():
    r = nv.VorbisReader(fixture_path("3test.ogg"), engine="oracle")
    assert "Xiph.Org" in r.tags.encoder_vendor
    r.dispose()


def test_stats():
    r = nv.VorbisReader(fixture_path("1test.ogg"), engine="oracle")
    r.read_all()
    st = r.stream_stats
    assert st.audio_bits > 0
    assert st.packet_count > 0
    assert st.effective_bit_rate > 0
    assert r.container_overhead_bits > 0
    assert r.container_waste_bits == 0
    r.dispose()


def test_golden_regression():
    """Bit-stable regression pin of the oracle decode (first frames of 1test)."""
    r = nv.VorbisReader(fixture_path("1test.ogg"), engine="oracle")
    pcm = r.read_all()
    r.dispose()
    # stable summary statistics (float64 accumulations of float32 data),
    # pinned to libvorbisfile's decode of the same file
    assert len(pcm) == 17640
    rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2)))
    assert abs(rms - 0.04921) < 5e-4
    peak = float(np.max(np.abs(pcm)))
    assert abs(peak - 0.20580) < 5e-3


def test_profiling_spans():
    """NVT_TRACE span accounting around a batch decode."""
    from nvorbis_tpu.utils import profiling
    from nvorbis_tpu.parallel.batch import BatchDecoder

    profiling.enable(True)
    profiling.reset()
    try:
        BatchDecoder([open(fixture_path("1test.ogg"), "rb").read()]).decode_all()
        snap = profiling.snapshot()
        assert "batch.dispatch" in snap and snap["batch.dispatch"][1] >= 1
        assert "batch.unpack" in snap
        assert "total_s" in profiling.report()
    finally:
        profiling.enable(False)
        profiling.reset()


def test_pure_python_fallback(monkeypatch):
    """With the native library disabled, the jax engine falls back to the
    python host plane and stays sample-exact."""
    import numpy as np
    import nvorbis_tpu as nv

    monkeypatch.setenv("NVT_NO_NATIVE", "1")
    got = nv.VorbisReader(fixture_path("1test.ogg"), engine="jax").read_all()
    monkeypatch.delenv("NVT_NO_NATIVE")
    ref = nv.VorbisReader(fixture_path("1test.ogg"), engine="oracle").read_all()
    assert len(got) == len(ref)
    assert float(np.abs(got - ref).max()) <= 2e-6
