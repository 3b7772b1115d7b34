"""Host engine (engine/host.py): parity, routing, and the jax-free promise.

The host engine (``engine="host"``, or ``engine="auto"`` with
``NVT_ENGINE=host``) runs C++ unpack + numpy DCT-IV synthesis + host
overlap-add with no jax import anywhere.  These tests pin:

- the DCT-IV IMDCT index mapping against the oracle basis matmul;
- full-stream parity vs the oracle on every reference fixture;
- bit-equality between the fused C++ lane and the pure-numpy lane;
- chunk-boundary carry, bad-packet drain, forward-only sources, seeks;
- that a decode completes in a subprocess where ``import jax`` raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import nvorbis_tpu as nv
from nvorbis_tpu.engine import host as host_mod
from nvorbis_tpu.engine.batcher import HostPipeline
from nvorbis_tpu.engine.host import HostBulkDecoder, imdct_rows
from nvorbis_tpu.native import NativeUnpacker
from nvorbis_tpu.synth.oracle import imdct_basis

from nvorbis_tpu.testgen.corpus import fixture_path
from tests.test_batch import _corrupt_audio_packet


FIXTURES = ["1test.ogg", "2test.ogg", "3test.ogg", "issue6test.ogg"]


def fixture(name):
    return fixture_path(name)


def _oracle(src):
    r = nv.VorbisReader(src, engine="oracle")
    pcm = r.read_all()
    meta = (r.channels, r.sample_rate)
    r.dispose()
    return pcm, meta


# ---------------------------------------------------------------- IMDCT


@pytest.mark.parametrize("n", [64, 128, 256, 512, 2048, 8192])
def test_imdct_dct4_mapping_exact(n, monkeypatch):
    """The DCT-IV formulation equals the spec basis matmul to f64 rounding
    (the index mapping itself is exact; only transform rounding differs)."""
    monkeypatch.setenv("NVT_HOST_F64", "1")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, n // 2)).astype(np.float32)
    ref = x.astype(np.float64) @ imdct_basis(n)
    got = imdct_rows(x, n)
    assert np.abs(got - ref.astype(np.float32)).max() <= 1e-6 * np.abs(
        ref
    ).max()


def test_imdct_f32_accuracy():
    """The default f32 DCT-IV stays well inside the 2e-6 parity budget."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((16, 1024)) * 0.3).astype(np.float32)
    ref = x.astype(np.float64) @ imdct_basis(2048)
    got = imdct_rows(x, 2048)
    assert np.abs(got - ref).max() <= 5e-7 * max(1.0, np.abs(ref).max())


# ------------------------------------------------------------- parity


@pytest.mark.parametrize("name", FIXTURES)
def test_host_read_all_matches_oracle(name):
    ref, _ = _oracle(fixture(name))
    r = nv.VorbisReader(fixture(name), engine="host")
    pcm = r.read_all()
    r.dispose()
    assert len(pcm) == len(ref)
    assert np.abs(pcm - ref).max() <= 2e-6


def test_fused_lane_bit_equals_numpy_lane(monkeypatch):
    """The C++ finish/OLA lane and the pure-numpy lane run the same f32
    operation sequence — outputs must be bit-identical."""
    src = fixture("3test.ogg")
    r = nv.VorbisReader(src, engine="host")
    fused = r.read_all()
    assert r._stream_decoder._pipeline._native.has_spec
    r.dispose()

    monkeypatch.setenv("NVT_HOST_NO_SPEC", "1")
    r = nv.VorbisReader(src, engine="host")
    plain = r.read_all()
    r.dispose()
    np.testing.assert_array_equal(fused, plain)


def test_chunk_boundary_carry(monkeypatch):
    """Tiny chunks force many carry frames across chunk boundaries."""
    monkeypatch.setattr(host_mod, "CHUNK_FRAMES", 32)
    monkeypatch.setattr(host_mod, "CAP_PER_SIZE", 16)
    ref, _ = _oracle(fixture("3test.ogg"))
    r = nv.VorbisReader(fixture("3test.ogg"), engine="host")
    pcm = r.read_all()
    r.dispose()
    assert len(pcm) == len(ref)
    assert np.abs(pcm - ref).max() <= 2e-6


@pytest.mark.parametrize("mode", ["type", "payload"])
def test_host_bad_packet_drain(tmp_path, mode):
    """Corrupted (CRC-repaired) packets drain the previous tail through
    the host engine identically to the oracle (StreamDecoder.cs:352-356)."""
    from nvorbis_tpu.testgen.ogg_writer import make_long_stream

    out = str(tmp_path / "long.ogg")
    make_long_stream(fixture("3test.ogg"), 4, out)
    blob = open(out, "rb").read()
    blob = _corrupt_audio_packet(blob, 0.3, mode)
    blob = _corrupt_audio_packet(blob, 0.7, mode)

    ref, _ = _oracle(blob)
    r = nv.VorbisReader(blob, engine="host")
    pcm = r.read_all()
    r.dispose()
    assert len(pcm) == len(ref)
    tol = 5e-6 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(pcm - ref).max()) <= tol


def test_host_forward_only_source():
    """Non-seekable sources use the provider pull path (no packet table)."""
    import io

    raw = open(fixture("3test.ogg"), "rb").read()

    class _Fwd(io.BytesIO):
        def seekable(self):
            return False

    ref, _ = _oracle(raw)
    r = nv.VorbisReader(_Fwd(raw), engine="host")
    pcm = r.read_all()
    r.dispose()
    assert len(pcm) == len(ref)
    assert np.abs(pcm - ref).max() <= 2e-6


def test_host_seek_and_stream_reads():
    ref, (ch, sr) = _oracle(fixture("3test.ogg"))
    r = nv.VorbisReader(fixture("3test.ogg"), engine="host")
    assert isinstance(r._stream_decoder._pipeline, HostPipeline)
    buf = np.zeros(4096 * ch, np.float32)
    n = r.read_samples(buf)
    assert np.abs(buf[:n] - ref[:n]).max() <= 5e-6
    r.sample_position = 44100
    assert r.sample_position == 44100
    n = r.read_samples(buf)
    want = ref[44100 * ch : 44100 * ch + n]
    assert np.abs(buf[:n] - want).max() <= 5e-6
    r.dispose()


def test_host_coupled_51_topology():
    """Coupled 5.1 Residue2: the C++ coupling/floor fusion on a multi-step
    coupling topology the stereo fixtures never exercise."""
    from nvorbis_tpu.testgen.vorbis_writer import make_simple_spec

    spec = make_simple_spec(channels=6, sample_rate=48000, residue_type=2,
                            couplings=[(0, 1), (2, 3), (4, 5)])
    blob = spec.build_stream(np.random.default_rng(11), 120)
    ref, _ = _oracle(blob)
    r = nv.VorbisReader(blob, engine="host")
    pcm = r.read_all()
    r.dispose()
    assert len(pcm) == len(ref)
    tol = 5e-6 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(pcm - ref).max()) <= tol


def test_batch_decoder_host_engine():
    from nvorbis_tpu.parallel.batch import BatchDecoder

    raw = open(fixture("3test.ogg"), "rb").read()
    ref, _ = _oracle(raw)
    bd = BatchDecoder([raw, raw], engine="host")
    assert bd._host_mode
    outs = bd.decode_all()
    assert len(outs) == 2
    for o in outs:
        assert len(o) == len(ref)
        assert np.abs(o - ref).max() <= 2e-6


def test_batch_decoder_host_threads(monkeypatch):
    """Per-stream thread-pool host decode (multi-core hosts): forced to 4
    threads here so the concurrent path runs even on a 1-core box —
    results must stay in order and bit-match the sequential decode (the
    shared unpacker is stateless per call, C++ scratch is thread-local)."""
    from nvorbis_tpu.parallel.batch import BatchDecoder

    raws = [open(fixture(n), "rb").read()
            for n in ("3test.ogg", "issue6test.ogg", "3test.ogg",
                      "2test.ogg")]
    seq = BatchDecoder(list(raws), engine="host").decode_all()
    monkeypatch.setenv("NVT_HOST_THREADS", "4")
    par = BatchDecoder(list(raws), engine="host").decode_all()
    assert len(par) == len(seq)
    for a, b in zip(par, seq):
        np.testing.assert_array_equal(a, b)


def test_host_engine_clip_semantics():
    """clip_samples + has_clipped flow through the host bulk path."""
    r = nv.VorbisReader(fixture("3test.ogg"), engine="host")
    r.clip_samples = True
    pcm = r.read_all()
    assert np.abs(pcm).max() <= np.float32(0.99999994)
    r.dispose()


@pytest.mark.parametrize("env", ["NVT_HOST_NO_SPEC", "NVT_HOST_F64"])
def test_multichunk_end_trim_non_fused_lanes(tmp_path, monkeypatch, env):
    """End-of-stream granule trim on a multi-chunk stream: the trimmed
    final span can be shorter than the previous frame's lapped tail, and
    the vectorized planner must fall back to the sequential clamp
    (engine/plan.py).  Before the round-4 fix the numpy OLA lane crashed
    with a broadcast ValueError here and the fused lane wrote past the
    final segment into buffer slack (found by review)."""
    from nvorbis_tpu.testgen.ogg_writer import make_long_stream

    out = str(tmp_path / "long.ogg")
    make_long_stream(fixture("3test.ogg"), 30, out)  # > CHUNK_FRAMES pkts
    ref, _ = _oracle(out)
    monkeypatch.setenv(env, "1")
    r = nv.VorbisReader(out, engine="host")
    pcm = r.read_all()
    r.dispose()
    assert len(pcm) == len(ref)
    tol = 5e-6 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(pcm - ref).max()) <= tol


def test_host_mode_enables_page_recycling(monkeypatch):
    """The host engine must install the page-recycling allocator policy
    exactly like the device planes do — without it a fresh process decodes
    at first-touch-fault speed (measured 88x vs 594x on the same workload;
    round-4 regression)."""
    from nvorbis_tpu.utils import hostmem

    calls = []
    monkeypatch.setattr(hostmem, "enable_page_recycling",
                        lambda: calls.append(1))
    from nvorbis_tpu.parallel.batch import BatchDecoder

    raw = open(fixture("1test.ogg"), "rb").read()
    bd = BatchDecoder([raw], engine="host")
    assert bd._host_mode and calls
    bd.decode_all()

    calls.clear()
    r = nv.VorbisReader(fixture("3test.ogg"), engine="host")
    # opening alone must NOT mutate the process-global allocator (the
    # policy is irreversible; short-clip opens are the common entry
    # point) — the bulk read applies it
    assert not calls
    r.read_all()
    assert calls
    r.dispose()


# ----------------------------------------------------------- jax-free


_JAXFREE_SCRIPT = r"""
import os, sys, importlib.abc

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax blocked: host engine must not import it")

sys.meta_path.insert(0, _Block())
assert "jax" not in sys.modules

import numpy as np
import nvorbis_tpu as nv
from nvorbis_tpu.testgen.corpus import STEREO, fixture_path

src = fixture_path(STEREO)
r = nv.VorbisReader(src, engine="host")
pcm = r.read_all()
r.dispose()
os.environ["NVT_ENGINE"] = "host"
r = nv.VorbisReader(src)  # auto, routed by NVT_ENGINE
pcm_auto = r.read_all()
r.dispose()
assert len(pcm) > 0 and len(pcm) == len(pcm_auto)
np.testing.assert_array_equal(pcm, pcm_auto)
assert "jax" not in sys.modules
# the batch plane's host mode is equally jax-free (module import included)
from nvorbis_tpu.parallel.batch import BatchDecoder
raw = open(src, "rb").read()
bd = BatchDecoder([raw, raw])  # auto + NVT_ENGINE=host -> host mode
assert bd._host_mode
outs = bd.decode_all()
assert len(outs) == 2 and all(len(o) == len(pcm) for o in outs)
assert "jax" not in sys.modules
# streaming + seek too
r = nv.VorbisReader(src, engine="host")
buf = np.zeros(4096 * r.channels, np.float32)
r.sample_position = 44100
n = r.read_samples(buf)
assert n > 0 and "jax" not in sys.modules
r.dispose()
print("JAXFREE_OK", len(pcm))
"""


def test_host_engine_decodes_with_jax_unimportable():
    """The host engine's hard promise: a full decode, an ``auto`` decode
    routed by ``NVT_ENGINE=host``, a batch decode, a seek and a streaming
    read complete in a process where ``import jax`` raises."""
    env = dict(os.environ)
    env.pop("NVT_ENGINE", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _JAXFREE_SCRIPT],
        env=env, capture_output=True, text=True, timeout=180, cwd=root,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAXFREE_OK" in proc.stdout
