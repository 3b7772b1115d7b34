import io

import pytest

from nvorbis_tpu.ogg.pages import PageScanner
from nvorbis_tpu.ogg.container import ContainerReader

from conftest import fixture_path

# page counts as libogg wrote them (tools/make_corpus.py --check)
EXPECTED_PAGES = {
    "1test.ogg": 3,
    "2test.ogg": 17,
    "3test.ogg": 25,
    "issue6test.ogg": 50,
}


class ForwardOnlyStream(io.RawIOBase):
    """Wrapper that hides seekability (reference: TestApp/ForwardOnlyStream.cs)."""

    def __init__(self, path):
        self._f = open(path, "rb")

    def read(self, n=-1):
        return self._f.read(n)

    def seekable(self):
        return False

    def close(self):
        self._f.close()


@pytest.mark.parametrize("name,count", sorted(EXPECTED_PAGES.items()))
def test_page_scan(name, count):
    with open(fixture_path(name), "rb") as f:
        sc = PageScanner(f)
        pages = []
        while True:
            p = sc.next_page()
            if p is None:
                break
            pages.append(p)
    assert len(pages) == count
    assert sc.waste_bits == 0
    assert pages[0].is_bos
    assert pages[-1].is_eos
    # CRC accepted every page; granules must not regress
    granules = [p.granule_pos for p in pages if p.granule_pos > 0]
    assert granules == sorted(granules)


def _all_packets_seekable(path):
    packets = []
    cont = ContainerReader(path)
    cont.new_stream_callback = None
    assert cont.try_init()
    provider = cont.get_streams()[0]
    while True:
        p = provider.get_next_packet()
        if p is None:
            break
        packets.append((p.data, p.granule_position, p.is_end_of_stream))
    cont.dispose()
    return packets


def _all_packets_forward_only(path):
    packets = []
    cont = ContainerReader(ForwardOnlyStream(path))
    assert cont.try_init()
    provider = cont.get_streams()[0]
    assert not provider.can_seek
    while True:
        p = provider.get_next_packet()
        if p is None:
            break
        packets.append((p.data, p.granule_position, p.is_end_of_stream))
    cont.dispose()
    return packets


@pytest.mark.parametrize("name", sorted(EXPECTED_PAGES))
def test_forward_only_matches_seekable(name):
    a = _all_packets_seekable(fixture_path(name))
    b = _all_packets_forward_only(fixture_path(name))
    assert len(a) == len(b)
    for (da, ga, ea), (db, gb, eb) in zip(a, b):
        assert da == db
        assert ga == gb
    # EOS flags agree on the final packet
    assert a[-1][2] == b[-1][2]


def test_peek_then_get():
    cont = ContainerReader(fixture_path("1test.ogg"))
    assert cont.try_init()
    provider = cont.get_streams()[0]
    peeked = provider.peek_next_packet()
    got = provider.get_next_packet()
    assert peeked.data == got.data
    nxt = provider.get_next_packet()
    assert nxt.data != got.data
    cont.dispose()


def test_granule_count():
    cont = ContainerReader(fixture_path("3test.ogg"))
    assert cont.try_init()
    provider = cont.get_streams()[0]
    assert provider.get_granule_count() == 286650
    cont.dispose()


def test_corrupt_page_is_skipped():
    raw = open(fixture_path("3test.ogg"), "rb").read()
    # flip a byte inside the 3rd page's payload region
    corrupted = bytearray(raw)
    corrupted[9000] ^= 0xFF
    sc = PageScanner(io.BytesIO(bytes(corrupted)))
    pages = []
    while True:
        p = sc.next_page()
        if p is None:
            break
        pages.append(p)
    assert len(pages) == EXPECTED_PAGES["3test.ogg"] - 1
    assert sc.waste_bits > 0
    # the page following the corrupt one is flagged resync
    assert any(p.is_resync for p in pages)


def test_non_vorbis_codec_hints():
    """Opening a non-Vorbis logical stream raises with a codec hint
    (reference: StreamDecoder.GetInvalidStreamException 70-103)."""
    import pytest
    import nvorbis_tpu as nv
    from nvorbis_tpu.errors import VorbisError
    from nvorbis_tpu.testgen.ogg_writer import paginate

    for head, hint in [
        (b"OpusHead" + bytes(8), "OPUS"),
        (b"\x7fFLAC" + bytes(8), "FLAC"),
        (b"Speex   " + bytes(8), "Speex"),
        (b"fishead\x00" + bytes(8), "Skeleton"),
    ]:
        blob = paginate([head], [-1], bos_pages=1)
        with pytest.raises(VorbisError) as e:
            nv.VorbisReader(blob, engine="oracle")
        assert hint in str(e.value), (hint, str(e.value))


def test_pure_garbage_raises():
    import pytest
    import nvorbis_tpu as nv
    from nvorbis_tpu.errors import VorbisError

    with pytest.raises(VorbisError):
        nv.VorbisReader(b"\x00" * 5000, engine="oracle")
