"""Encode the bundled fixture corpus (tests/fixtures/*.ogg).

Four seeded synthetic signals are encoded with the system's Xiph encoder
(``libvorbisenc.so.2`` + ``libogg.so.0``, through ctypes — the same way
tests/libvorbis_oracle.py binds libvorbisfile), so every fixture is a real
encoder's bitstream: floor1, residue 2, 256/2048 blocks, libogg paging.

The files are committed; this script documents and reproduces them:

    python tools/make_corpus.py            # rewrite tests/fixtures/*.ogg
    python tools/make_corpus.py --check    # print what libvorbisfile reads

Roles the tests rely on (see tests/fixtures/README.md):

- ``1test.ogg``      mono 44.1 kHz, ~0.4 s (single short clip);
- ``2test.ogg``      mono 44.1 kHz, ~7 s, with transients (both block sizes);
- ``3test.ogg``      stereo 44.1 kHz, ~6.5 s, a full-scale square-wave
  passage whose decode overshoots the clip point;
- ``issue6test.ogg`` stereo 44.1 kHz, ~12.4 s, whose audio pages' granules
  all claim ``GRANULE_SHIFT`` samples more than its packets hold (rewritten
  after encoding, CRCs recomputed with ``nvorbis_tpu.ogg.crc``).
"""

import ctypes
import os
import struct
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from nvorbis_tpu.ogg.crc import crc32  # noqa: E402
from nvorbis_tpu.testgen.corpus import FIXTURE_DIR  # noqa: E402

RATE = 44100
GRANULE_SHIFT = 63


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


def _declare(lib, restype, *names_argtypes):
    for name, argtypes in names_argtypes:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _libs():
    enc = ctypes.CDLL("libvorbisenc.so.2")
    vorbis = ctypes.CDLL("libvorbis.so.0")
    ogg = ctypes.CDLL("libogg.so.0")
    vp, i, pkt = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_OggPacket)
    page = ctypes.POINTER(_OggPage)
    _declare(enc, i, ("vorbis_encode_init_vbr",
                      [vp, ctypes.c_long, ctypes.c_long, ctypes.c_float]))
    _declare(vorbis, i,
             ("vorbis_comment_add_tag",
              [vp, ctypes.c_char_p, ctypes.c_char_p]),
             ("vorbis_analysis_init", [vp, vp]),
             ("vorbis_block_init", [vp, vp]),
             ("vorbis_analysis_headerout", [vp, vp, pkt, pkt, pkt]),
             ("vorbis_analysis_wrote", [vp, i]),
             ("vorbis_analysis_blockout", [vp, vp]),
             ("vorbis_analysis", [vp, pkt]),
             ("vorbis_bitrate_addblock", [vp]),
             ("vorbis_bitrate_flushpacket", [vp, pkt]),
             ("vorbis_block_clear", [vp]))
    _declare(vorbis, None, ("vorbis_info_init", [vp]),
             ("vorbis_comment_init", [vp]), ("vorbis_dsp_clear", [vp]),
             ("vorbis_comment_clear", [vp]), ("vorbis_info_clear", [vp]))
    _declare(vorbis, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
             ("vorbis_analysis_buffer", [vp, i]))
    _declare(ogg, i, ("ogg_stream_init", [vp, i]),
             ("ogg_stream_packetin", [vp, pkt]),
             ("ogg_stream_flush", [vp, page]),
             ("ogg_stream_pageout", [vp, page]),
             ("ogg_stream_clear", [vp]))
    return enc, vorbis, ogg


def encode(pcm: np.ndarray, quality: float, serial: int, title: str) -> bytes:
    """Encode float PCM ``[samples, channels]`` in [-1, 1] to Ogg Vorbis."""
    enc, vb_lib, ogg = _libs()
    channels = pcm.shape[1]
    # opaque libvorbis/libogg state, over-allocated (x86-64 sizes are far
    # below these)
    vi = ctypes.create_string_buffer(1024)
    vc = ctypes.create_string_buffer(1024)
    vd = ctypes.create_string_buffer(8192)
    vb = ctypes.create_string_buffer(8192)
    os_ = ctypes.create_string_buffer(16384)
    vb_lib.vorbis_info_init(vi)
    rc = enc.vorbis_encode_init_vbr(vi, channels, RATE, quality)
    if rc:
        raise RuntimeError(f"vorbis_encode_init_vbr failed: {rc}")
    vb_lib.vorbis_comment_init(vc)
    vb_lib.vorbis_comment_add_tag(vc, b"TITLE", title.encode())
    vb_lib.vorbis_comment_add_tag(vc, b"ENCODER", b"tools/make_corpus.py")
    vb_lib.vorbis_analysis_init(vd, vi)
    vb_lib.vorbis_block_init(vd, vb)
    ogg.ogg_stream_init(os_, serial)

    out = bytearray()
    page = _OggPage()

    def take_page():
        out.extend(ctypes.string_at(page.header, page.header_len))
        out.extend(ctypes.string_at(page.body, page.body_len))

    hdr = [_OggPacket() for _ in range(3)]
    vb_lib.vorbis_analysis_headerout(vd, vc, *(ctypes.byref(p) for p in hdr))
    for p in hdr:
        ogg.ogg_stream_packetin(os_, ctypes.byref(p))
    # headers end on their own page, as the spec asks
    while ogg.ogg_stream_flush(os_, ctypes.byref(page)):
        take_page()

    op = _OggPacket()

    def drain():
        while vb_lib.vorbis_analysis_blockout(vd, vb) == 1:
            vb_lib.vorbis_analysis(vb, None)
            vb_lib.vorbis_bitrate_addblock(vb)
            while vb_lib.vorbis_bitrate_flushpacket(vd, ctypes.byref(op)):
                ogg.ogg_stream_packetin(os_, ctypes.byref(op))
                while ogg.ogg_stream_pageout(os_, ctypes.byref(page)):
                    take_page()

    step = 1024
    planes = np.ascontiguousarray(pcm.T, dtype=np.float32)  # [C, samples]
    for i in range(0, planes.shape[1], step):
        blk = np.ascontiguousarray(planes[:, i : i + step])
        n = blk.shape[1]
        buf = vb_lib.vorbis_analysis_buffer(vd, n)
        for c in range(channels):
            ctypes.memmove(buf[c], blk[c].ctypes.data, n * 4)
        vb_lib.vorbis_analysis_wrote(vd, n)
        drain()
    vb_lib.vorbis_analysis_wrote(vd, 0)  # end of stream
    drain()
    while ogg.ogg_stream_flush(os_, ctypes.byref(page)):
        take_page()

    ogg.ogg_stream_clear(os_)
    vb_lib.vorbis_block_clear(vb)
    vb_lib.vorbis_dsp_clear(vd)
    vb_lib.vorbis_comment_clear(vc)
    vb_lib.vorbis_info_clear(vi)
    return bytes(out)


def shift_granules(blob: bytes, shift: int) -> bytes:
    """Add ``shift`` to every audio page's granule; recompute the CRCs."""
    out = bytearray()
    pos = 0
    while pos < len(blob):
        assert blob[pos : pos + 4] == b"OggS"
        nseg = blob[pos + 26]
        size = 27 + nseg + sum(blob[pos + 27 : pos + 27 + nseg])
        page = bytearray(blob[pos : pos + size])
        (gran,) = struct.unpack_from("<q", page, 6)
        if gran > 0:
            struct.pack_into("<q", page, 6, gran + shift)
            struct.pack_into("<I", page, 22, 0)
            struct.pack_into("<I", page, 22, crc32(bytes(page)))
        out += page
        pos += size
    return bytes(out)


# -- seeded signals ------------------------------------------------------------


def _t(secs):
    return np.arange(int(round(secs * RATE))) / RATE


def _tone(t, f, partials=4):
    return sum(np.sin(2 * np.pi * f * k * t) / k for k in range(1, partials + 1))


def _melody(rng, secs, note_secs, level):
    """Notes of harmonic tones with decaying envelopes and noise hits: the
    attacks and hits make the encoder switch to short blocks."""
    t = _t(secs)
    x = np.zeros_like(t)
    n_notes = int(np.ceil(secs / note_secs))
    for k in range(n_notes):
        t0 = k * note_secs
        m = (t >= t0) & (t < t0 + note_secs)
        f = 110.0 * 2 ** (rng.integers(0, 36) / 12.0)
        env = np.exp(-(t[m] - t0) * rng.uniform(2.0, 8.0))
        x[m] += env * _tone(t[m] - t0, f)
        if rng.random() < 0.4:  # percussive noise burst
            hit = m & (t < t0 + 0.03)
            x[hit] += rng.standard_normal(hit.sum()) * np.exp(
                -(t[hit] - t0) * 120.0)
    x += 0.01 * rng.standard_normal(len(t))
    return level * x / np.max(np.abs(x))


def signals():
    """name -> (pcm [samples, channels], quality)."""
    out = {}
    rng = np.random.default_rng(20261016)
    t = _t(0.4)
    mono = np.exp(-t * 6.0) * _tone(t, 440.0, 6) + 0.02 * rng.standard_normal(
        len(t))
    out["1test.ogg"] = ((0.2 * mono / np.max(np.abs(mono)))[:, None], 0.3)

    out["2test.ogg"] = (_melody(rng, 7.0, 0.25, 0.5)[:, None], 0.3)

    # stereo with a near-full-scale tone passage: coding noise pushes
    # some decoded samples past +/-1, so the decode clips
    left = _melody(rng, 6.5, 0.5, 0.6)
    right = 0.7 * np.roll(left, 220) + 0.3 * _melody(rng, 6.5, 0.33, 0.6)
    t = _t(6.5)
    hot = (t >= 2.0) & (t < 2.5)
    tone = 0.995 * np.sin(2 * np.pi * 440.0 * t[hot])
    left[hot] = tone
    right[hot] = -tone
    out["3test.ogg"] = (np.stack([left, right], axis=1), 0.4)

    left = _melody(rng, 12.43, 0.4, 0.7)
    right = 0.6 * np.roll(left, 441) + 0.4 * _melody(rng, 12.43, 0.3, 0.7)
    out["issue6test.ogg"] = (np.stack([left, right], axis=1), 0.4)
    return out


def build(out_dir=FIXTURE_DIR):
    os.makedirs(out_dir, exist_ok=True)
    for k, (name, (pcm, q)) in enumerate(sorted(signals().items())):
        blob = encode(np.clip(pcm, -1.0, 1.0), q, serial=0x4E560000 + k,
                      title=name)
        if name == "issue6test.ogg":
            blob = shift_granules(blob, GRANULE_SHIFT)
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(blob)
        print(f"{name}: {len(blob)} bytes")


def check(out_dir=FIXTURE_DIR):
    """What libvorbisfile (the independent decoder) reads from each file."""
    sys.path.insert(0, os.path.join(_REPO, "tests"))
    import libvorbis_oracle as lvo
    from nvorbis_tpu.testgen.ogg_writer import split_pages

    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".ogg"):
            continue
        path = os.path.join(out_dir, name)
        pcm = lvo.decode_file(path)
        blob = open(path, "rb").read()
        pages = split_pages(blob)
        last_granule = struct.unpack_from("<q", pages[-1], 6)[0]
        rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2)))
        print(f"{name}: channels={pcm.shape[1]} decoded={len(pcm)} "
              f"last_granule={last_granule} pages={len(pages)} "
              f"rms={rms:.5f} peak={float(np.abs(pcm).max()):.5f}")


if __name__ == "__main__":
    if "--check" in sys.argv[1:]:
        check()
    else:
        build()
        check()
