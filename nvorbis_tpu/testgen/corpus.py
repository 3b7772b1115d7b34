"""The bundled fixture corpus: real-encoder Ogg Vorbis files in
``tests/fixtures/`` (encoded by ``tools/make_corpus.py``; roles in
``tests/fixtures/README.md``).  Tests, the bench, the tools and
``chip_smoke.py`` all read fixtures through :func:`fixture_path`."""

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
FIXTURE_DIR = os.path.join(_ROOT, "tests", "fixtures")
# derived long-form streams (gitignored, rebuilt on demand)
CACHE_DIR = os.path.join(_ROOT, ".benchcache")

MONO_SHORT = "1test.ogg"   # mono 44.1 kHz, ~0.4 s
MONO_LONG = "2test.ogg"    # mono 44.1 kHz, ~7 s
STEREO = "3test.ogg"       # stereo 44.1 kHz, ~6.5 s, overshoots the clip
STEREO_SHIFTED = "issue6test.ogg"  # stereo ~12.4 s, granules over-claim
ALL = (MONO_SHORT, MONO_LONG, STEREO, STEREO_SHIFTED)


def fixture_path(name: str) -> str:
    return os.path.join(FIXTURE_DIR, name)


def long_stream(repeats: int, name: str = STEREO) -> str:
    """Path of a long-form stream: fixture ``name``'s audio packets
    repeated ``repeats`` times (``testgen.ogg_writer.make_long_stream``),
    built once under ``.benchcache/``.  The stereo fixture x64 is about
    7 minutes of audio."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    stem = name.split(".")[0].replace("test", "")
    path = os.path.join(CACHE_DIR, f"long{stem}_x{repeats}.ogg")
    if not os.path.exists(path):
        from nvorbis_tpu.testgen.ogg_writer import make_long_stream

        tmp = f"{path}.{os.getpid()}.tmp"
        make_long_stream(fixture_path(name), repeats, tmp)
        os.replace(tmp, path)
    return path
