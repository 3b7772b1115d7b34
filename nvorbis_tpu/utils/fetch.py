"""Device->host transfer helpers and the decode loops' transfer knobs.

- ``NVT_FETCH_OVERLAP`` (default on): overlap each chunk's device->host
  fetch with the next chunk's host unpack, upload and compute.
- ``NVT_READY_MAIN`` (default on): block on a chunk's device compute on
  the main thread before handing its transfer to the fetch worker.
- ``NVT_FETCH_INT16`` (default off): lossy 16-bit PCM transport.

Their defaults are not measured on the current accelerator yet.
"""

import os

import numpy as np


def int16_transport_enabled() -> bool:
    """Opt-in lossy PCM transport (``NVT_FETCH_INT16=1``).

    Quantizes to 16 bits on-device — the delivery precision of virtually
    every audio sink, and exactly what libvorbisfile's ov_read() hands
    out — which halves the device->host bytes.  ~3e-5 quantization error,
    so parity tests never enable it.
    """
    return os.environ.get("NVT_FETCH_INT16", "") not in ("", "0")


def overlap_fetches() -> bool:
    """Should decode loops overlap device->host fetches with the next
    chunk's upload/compute?  Default yes; ``NVT_FETCH_OVERLAP=0``
    serializes them."""
    return os.environ.get("NVT_FETCH_OVERLAP", "") != "0"


def ready_on_main() -> bool:
    """``NVT_READY_MAIN`` (default on): decode loops block on each chunk's
    device compute on the main thread before handing the transfer to the
    fetch worker.  Set ``0`` to overlap the compute wait into the fetch
    worker instead."""
    return os.environ.get("NVT_READY_MAIN", "1") != "0"


def block_ready(arr):
    import jax

    return jax.block_until_ready(arr)


def fetch_np(arr) -> np.ndarray:
    """Fetch a jax array to host memory as numpy."""
    from nvorbis_tpu.utils.profiling import span

    with span("fetch.ready"):
        arr = block_ready(arr)
    with span("fetch.xfer"):
        return np.asarray(arr)


def dequantize_i16(host: np.ndarray) -> np.ndarray:
    """int16 wire samples -> float32 in [-CLIP_LIMIT, CLIP_LIMIT].

    +/-32767 would dequantize to exactly +/-1.0 — just past the library's
    documented +/-0.99999994 output bound, and enough to spuriously set
    ``has_clipped`` downstream — so clamp; the 6e-8 excess is far inside
    the ~3e-5 lossy-transport budget."""
    from nvorbis_tpu.utils.bitmath import CLIP_LIMIT

    out = host.astype(np.float32) * np.float32(1.0 / 32767.0)
    np.clip(out, -CLIP_LIMIT, CLIP_LIMIT, out=out)
    return out


def fetch_pcm(arr, quantized: bool = False) -> np.ndarray:
    """Fetch device PCM to host; int16 over the wire when opted in via
    ``NVT_FETCH_INT16=1`` (see :func:`int16_transport_enabled`).

    ``quantized=True``: the chunk program already emitted int16 in its
    epilogue (fused quantization) — just fetch and dequantize."""
    if quantized:
        return dequantize_i16(fetch_np(arr))
    if not int16_transport_enabled():
        return fetch_np(arr)
    import jax.numpy as jnp

    q = jnp.round(jnp.clip(arr, -1.0, 1.0) * 32767.0).astype(jnp.int16)
    return dequantize_i16(fetch_np(q))
