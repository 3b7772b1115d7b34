"""Bulk (device overlap-add) decode path: parity with streaming + oracle,
lapping planner semantics, and the synthesized long-stream fixture."""

import numpy as np
import pytest

import nvorbis_tpu as nv
from nvorbis_tpu.engine.bulk import StreamPlanner

from conftest import fixture_path

FIXTURES = ["1test.ogg", "2test.ogg", "3test.ogg", "issue6test.ogg"]


def _decode_three_ways(path):
    o = nv.VorbisReader(path, engine="oracle").read_all()
    rb = nv.VorbisReader(path, engine="jax")
    b = rb.read_all()
    used_bulk = rb._stream_decoder._eos_found
    rb.dispose()
    rs = nv.VorbisReader(path, engine="jax")
    rs._stream_decoder._started = True  # force the streaming window path
    s = rs.read_all()
    rs.dispose()
    return o, b, s, used_bulk


@pytest.mark.parametrize("name", FIXTURES)
def test_bulk_matches_streaming_and_oracle(name):
    o, b, s, _ = _decode_three_ways(fixture_path(name))
    assert len(o) == len(b) == len(s)
    np.testing.assert_allclose(b, o, atol=2e-6, rtol=0)
    # bulk vs streaming share the device synthesis except the streaming
    # pipeline's host-synthesized ramp-up windows (<=32 frames; cheap
    # seeks/startup) — f32 rounding only
    np.testing.assert_allclose(b, s, atol=2e-6, rtol=0)


def test_bulk_position_and_subsequent_reads():
    r = nv.VorbisReader(fixture_path("3test.ogg"), engine="jax")
    pcm = r.read_all()
    assert r.sample_position == len(pcm) // r.channels
    assert r.is_end_of_stream
    buf = np.zeros(512, np.float32)
    assert r.read_samples(buf) == 0
    # seek back and read again (streaming path after bulk)
    r.sample_position = 1000
    n = r.read_samples(buf)
    assert n == 512
    r.dispose()


def test_eos_trim_is_order_independent():
    """The final-granule end trim must not depend on whether TotalSamples
    pre-scanned the page index (regression: a trailing empty EOS marker page
    was dropped, losing the trim on sequential decode)."""
    path = fixture_path("issue6test.ogg")
    r = nv.VorbisReader(path, engine="oracle")
    pcm_no_prescan = r.read_all()
    r.dispose()

    r = nv.VorbisReader(path, engine="oracle")
    assert r.total_samples == 548226
    pcm_prescan = r.read_all()
    r.dispose()

    assert len(pcm_no_prescan) == len(pcm_prescan) == 548163 * 2
    np.testing.assert_array_equal(pcm_no_prescan, pcm_prescan)


def test_planner_failure_drain_and_first_frame():
    p = StreamPlanner()
    # first frame: nothing consumed, lead-in only
    a = p.add(True, 0, 512, 1024, None, False, False, block_size=1024)
    assert a.samples == 0 and p.emitted == 0
    # second frame laps normally
    b = p.add(True, 0, 512, 1024, None, False, False,
              block_size=1024, prev_plan=a)
    assert b.samples == 512 and p.emitted == 512
    # failed packet drains the previous tail
    f = p.add(False, 0, 0, 0, None, False, False)
    assert not f.ok and p.emitted == 512 + 512
    # next good frame starts past the drained tail, without lapping
    c = p.add(True, 0, 512, 1024, None, False, False,
              block_size=1024, prev_plan=b)
    assert p.emitted == 1024 + 512
    # end trim: granule claims 100 fewer samples
    d = p.add(True, 0, 512, 1024, 1024 + 512 + 512 - 100, True, False,
              block_size=1024, prev_plan=c)
    assert d.samples == 512 - 100
    assert p.emitted == 1024 + 512 + 412


def test_planner_tail_clamp_on_malformed_transition():
    p = StreamPlanner()
    a = p.add(True, 0, 1024, 2048, None, False, False, block_size=2048)
    # next frame is a short block whose room cannot hold the long tail:
    # the scatterable tail clamps to the next frame's consumed span
    b = p.add(True, 32, 128, 192, None, False, False,
              block_size=256, prev_plan=a)
    assert a.total == a.valid + (128 - 32)


def test_long_stream_generator_roundtrip(tmp_path):
    from nvorbis_tpu.testgen.ogg_writer import make_long_stream

    out = str(tmp_path / "long.ogg")
    _, claimed = make_long_stream(fixture_path("3test.ogg"), 3, out)
    o = nv.VorbisReader(out, engine="oracle")
    assert o.total_samples == claimed
    pcm_o = o.read_all()
    assert len(pcm_o) == claimed * 2
    o.dispose()

    b = nv.VorbisReader(out, engine="jax").read_all()
    assert len(b) == len(pcm_o)
    np.testing.assert_allclose(b, pcm_o, atol=2e-6, rtol=0)


@pytest.mark.slow
def test_bulk_multi_chunk_synthetic():
    """A stream spanning multiple device chunks: cross-chunk carry frames
    and the per-size collection caps must keep the lapped output exact."""
    import numpy as np
    from nvorbis_tpu.testgen.vorbis_writer import make_simple_spec

    spec = make_simple_spec(channels=2, residue_type=2, block0=64, block1=128)
    blob = spec.build_stream(np.random.default_rng(71), 20000)
    ref = nv.VorbisReader(blob, engine="oracle").read_all()
    got = nv.VorbisReader(blob, engine="jax").read_all()
    assert len(got) == len(ref)
    assert float(np.abs(got - ref).max()) <= 2e-6


def test_bulk_forward_only_source():
    """A non-seekable source still reaches the bulk fast plane: the packet
    table needs seekability but the provider-pull path feeds the same
    fused chunk programs (the reference's forward-only path is a
    first-class citizen, Ogg/ForwardOnlyPacketProvider.cs)."""
    import io

    import numpy as np
    import nvorbis_tpu.engine.bulk as bulk_mod
    from conftest import fixture_path

    class _Fwd(io.BytesIO):
        def seekable(self):
            return False

    raw = open(fixture_path("3test.ogg"), "rb").read()
    used = {"n": 0}
    orig = bulk_mod.BulkDecoder.run

    def traced(self):
        used["n"] += 1
        return orig(self)

    bulk_mod.BulkDecoder.run = traced
    try:
        got = nv.VorbisReader(_Fwd(raw)).read_all()
    finally:
        bulk_mod.BulkDecoder.run = orig
    assert used["n"] == 1
    ref = nv.VorbisReader(fixture_path("3test.ogg"), engine="oracle").read_all()
    assert len(got) == len(ref)
    assert float(np.abs(got - ref).max()) <= 2e-6
