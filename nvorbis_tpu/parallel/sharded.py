"""Multi-chip sharded synthesis: the scale-out plane.

Vorbis decode streams are embarrassingly parallel, so the first-class
parallelism axis is the *frame/stream batch* (data parallel over the mesh
``stream`` axis).  The IMDCT matmul is additionally tensor-parallel over the
``freq`` axis: the spectral (contraction) dimension is sharded, each chip
multiplies its slice of the ``[n/2, n]`` cosine basis, and XLA inserts the
``psum`` over ``freq`` (NCCL over the device interconnect on GPUs); nothing
is hand-written.

Unlike :class:`~nvorbis_tpu.synth.device.DeviceSynth` (which bakes one
stream's floor/window tables in as constants), the sharded program is
*stream-agnostic*: the floor X positions, window tables, and IMDCT basis are
runtime arguments, so one compiled program serves every stream that shares
``(n, channels, coupling topology, window count, max posts)`` — which is what
a 64-stream batch decoder needs.

Reference parity anchors: NVorbis/Mapping.cs:137-182 (coupling),
NVorbis/Floor1.cs:316-341 (render), NVorbis/Mdct.cs:65-313 (IMDCT),
NVorbis/Mode.cs:153-170 (window).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nvorbis_tpu.codec.floor import INVERSE_DB_TABLE
from nvorbis_tpu.synth.device import (
    _apply_inverse_coupling,
    _render_floor1_curves,
)

STREAM_AXIS = "stream"
FREQ_AXIS = "freq"


def build_mesh(n_devices=None, model_parallel=None, devices=None):
    """Build a 2D ``(stream, freq)`` device mesh.

    ``model_parallel`` (the ``freq`` extent) defaults to 2 when the device
    count is even, exercising the tensor-parallel IMDCT path; the remaining
    devices form the data-parallel ``stream`` axis.  ``devices`` pins an
    explicit device list (e.g. ``jax.devices("cpu")`` for a virtual-mesh
    dryrun); default is the default platform's devices.  The mesh follows
    the algorithm only: on all-to-all linked cards any grouping is as good
    as another.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if model_parallel is None:
        model_parallel = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if n_devices % model_parallel != 0:
        raise ValueError("n_devices must be divisible by model_parallel")
    grid = np.array(devices[:n_devices]).reshape(
        n_devices // model_parallel, model_parallel
    )
    return Mesh(grid, (STREAM_AXIS, FREQ_AXIS))


def make_sharded_synth(mesh, coupling_steps=()):
    """Jitted stream-agnostic synthesis step sharded over ``mesh``.

    Returns ``fn(residue, ys, used, has_floor, window_index, xs, windows,
    basis) -> pcm [B, C, n]`` where:

    - ``residue [B, C, n2]`` is sharded ``(stream, None, freq)``;
    - ``basis [n2, n]`` is sharded ``(freq, None)`` — the contraction
      dimension, so the matmul psum crosses the ``freq`` axis;
    - per-frame metadata is sharded over ``stream`` only;
    - ``xs [B, C, P]``/``windows [B, W, n]`` are per-frame (gathered on host
      from each frame's source stream), sharded over ``stream``;
    - output ``pcm [B, C, n]`` is sharded ``(stream, None, None)``.
    """
    idb = jnp.asarray(INVERSE_DB_TABLE)
    coupling = tuple(coupling_steps)

    def synth(residue, ys, used, has_floor, window_index, xs, windows, basis):
        n2 = residue.shape[-1]
        n = basis.shape[-1]
        residue = _apply_inverse_coupling(residue, coupling)
        curve = _render_floor1_curves(xs, ys, used, has_floor, idb, n2)
        spectrum = residue * curve
        pcm = jnp.dot(
            spectrum.reshape(-1, n2),
            basis,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(residue.shape[0], residue.shape[1], n)
        win = jnp.take_along_axis(
            windows, window_index[:, None, None], axis=1
        )  # [B, 1, n]
        return pcm * win

    s = lambda *spec: NamedSharding(mesh, P(*spec))
    in_shardings = (
        s(STREAM_AXIS, None, FREQ_AXIS),  # residue
        s(STREAM_AXIS, None, None),       # ys
        s(STREAM_AXIS, None, None),       # used
        s(STREAM_AXIS, None),             # has_floor
        s(STREAM_AXIS),                   # window_index
        s(STREAM_AXIS, None, None),       # xs
        s(STREAM_AXIS, None, None),       # windows
        s(FREQ_AXIS, None),               # basis
    )
    out_shardings = s(STREAM_AXIS, None, None)
    return jax.jit(synth, in_shardings=in_shardings, out_shardings=out_shardings)
