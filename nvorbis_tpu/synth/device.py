"""Device plane: batched Vorbis frame synthesis as one fused XLA program.

Each :class:`DeviceSynth` is specialized to one *mode* of one stream setup
(block size, windows, mapping topology, per-channel floor configuration are
all static), and compiles one jitted program per padded batch size.  The
program performs, for a batch of ``B`` frames over ``C`` channels:

1. inverse square-polar channel coupling (``NVorbis/Mapping.cs:137-182``),
2. floor1 curve render — the closed form of the reference's integer Bresenham
   walk (``NVorbis/Floor1.cs:316-341``) vectorized over bins — plus the
   256-entry inverse-dB gain gather (``NVorbis/Floor1.cs:345-410``),
3. floor multiply (``NVorbis/Floor1.cs:186-222``),
4. inverse MDCT as one matmul against a precomputed ``[n/2, n]`` cosine
   basis (the same transform the reference computes with the stb_vorbis
   8-step FFT, ``NVorbis/Mdct.cs:65-313``),
5. window multiply with the per-frame lapping window (``NVorbis/Mode.cs:153-170``).

All ops are static-shaped; the only data-dependent values are tensor
contents, so XLA fuses 1-3 and 5 around the single matmul.  bfloat16 is NOT
used: the parity budget (1e-6 vs the scalar oracle) requires float32 with
``Precision.HIGHEST`` (on a GPU this keeps the matmul out of TF32).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from nvorbis_tpu.codec.floor import INVERSE_DB_TABLE, Floor1
from nvorbis_tpu.synth.oracle import imdct_basis

# pad value for unused floor-post slots: larger than any bin index so padded
# posts never match `xs <= bin`, but still keeps xs sorted
_XS_PAD = np.int32(1 << 24)


def floor1_bin_map(xs_sorted, n2):
    """Host-side static bin->post map for the fast floor render path.

    ``xs_sorted``: numpy int array ``[..., P]`` of sorted post X positions
    (pads ``_XS_PAD`` at the end).  Returns int32 ``[..., n2]``: for each
    spectral bin, the index of the last post (used or not) with ``x <= bin``,
    or -1.  Post X positions come from the setup header
    (NVorbis/Floor1.cs:92-132), so this map is a per-stream constant.
    """
    xs_sorted = np.asarray(xs_sorted)
    bins = np.arange(n2)
    out = np.empty(xs_sorted.shape[:-1] + (n2,), np.int32)
    for idx in np.ndindex(xs_sorted.shape[:-1]):
        out[idx] = np.searchsorted(xs_sorted[idx], bins, side="right") - 1
    return out


def _render_floor1_curves(xs, ys, used, has_floor, idb_table, n2, sl=None):
    """Vectorized floor1 polyline render -> linear gains ``[B, C, n2]``.

    ``xs``: int32 sorted post X positions (padded with ``_XS_PAD``) — either
    ``[C, P]`` (static per-stream tables, the single-stream path) or
    ``[B, C, P]`` (per-frame tables, the stream-agnostic sharded path);
    ``ys``/``used``: ``[B, C, P]`` per-frame post values and used flags in
    the same sorted order; ``has_floor``: ``[B, C]``; ``sl``: optional
    :func:`floor1_bin_map` of ``xs`` (``[C, n2]`` or ``[B, C, n2]``) — with
    it, neighbor search is a P-length cumulative scan plus two cheap batched
    gathers instead of an O(P*n2) compare-reduce.

    Closed form of ``Floor1.RenderLineMulti`` (NVorbis/Floor1.cs:316-341):
    for bin x between enclosing used posts (lx,ly)-(hx,hy),
    ``y = ly + sign(dy) * floor((x-lx)*|dy| / adx)`` with
    ``adx = min(hx, n2) - lx`` (the reference clips X but not Y at n2, which
    alters the final segment's slope; reproduced).
    """
    B, C, P = ys.shape
    ys = ys.astype(jnp.int32)
    if xs.ndim == 2:
        xs = jnp.broadcast_to(xs[None], (B, C, P))
    else:
        xs = jnp.broadcast_to(xs, (B, C, P))

    # Each post packs into a single ordered key ``(x << 9) | (y + 128)``
    # (post X fits 15 bits; multiplied post Y lies in [-126, 381] — the
    # range-86/multiplier-3 configuration can go negative and the raw root
    # posts can exceed the range — so a +128 bias keeps the field in
    # [2, 509], 9 bits).  Per bin:
    #   left  neighbor = max key over used posts with x <= bin
    #   right neighbor = min key over used posts with x >  bin
    # and (x, y) unpack by shift/mask.  Posts at/after n2 still participate
    # as right neighbors (the reference clips X at n2 mid-segment, not the
    # post list).  Padded slots (xs == _XS_PAD) are masked via ``used``.
    _NO_RIGHT = jnp.int32(1 << 30)
    _Y_BIAS = 128
    raw_keys = (jnp.clip(xs, 0, (1 << 15) - 1) << 9) | jnp.clip(
        ys + _Y_BIAS, 0, 511
    )
    lkeys = jnp.where(used, raw_keys, -1)
    rkeys = jnp.where(used, raw_keys, _NO_RIGHT)

    if sl is not None:
        # Fast path: posts are sorted by x, so "largest used key with
        # x <= bin" = cummax at the static map position, and "smallest used
        # key with x > bin" = suffix cummin one past it.  Scans are over
        # P (tiny); the per-bin work is two gathers from P-entry tables.
        lkey_p = jax.lax.cummax(lkeys, axis=2)                     # [B, C, P]
        rkey_p = jax.lax.cummin(rkeys[:, :, ::-1], axis=2)[:, :, ::-1]
        rkey_p = jnp.concatenate(
            [rkey_p, jnp.full((B, C, 1), _NO_RIGHT, dtype=jnp.int32)], axis=2
        )
        if sl.ndim == 2:
            sl = jnp.broadcast_to(sl[None], (B, C, n2))
        lkey = jnp.where(
            sl >= 0,
            jnp.take_along_axis(lkey_p, jnp.clip(sl, 0, P - 1), axis=2),
            jnp.int32(-1),
        )
        rkey = jnp.take_along_axis(rkey_p, jnp.minimum(sl + 1, P), axis=2)
    else:
        # Generic path (per-frame dynamic xs): compare-and-reduce over the
        # post axis, accumulated with a loop to bound live memory.
        bins = jax.lax.broadcasted_iota(jnp.int32, (B, C, n2), 2)

        def body(p, carry):
            lk, rk = carry
            xp = jax.lax.dynamic_slice_in_dim(xs, p, 1, axis=2)
            lp = jax.lax.dynamic_slice_in_dim(lkeys, p, 1, axis=2)
            rp = jax.lax.dynamic_slice_in_dim(rkeys, p, 1, axis=2)
            lk = jnp.maximum(lk, jnp.where(xp <= bins, lp, -1))
            rk = jnp.minimum(rk, jnp.where(xp > bins, rp, _NO_RIGHT))
            return lk, rk

        lkey0 = jnp.full((B, C, n2), -1, dtype=jnp.int32)
        rkey0 = jnp.full((B, C, n2), _NO_RIGHT, dtype=jnp.int32)
        lkey, rkey = jax.lax.fori_loop(0, P, body, (lkey0, rkey0))

    has_right = rkey < _NO_RIGHT

    lx = lkey >> 9
    ly = (lkey & 511) - _Y_BIAS
    hx = rkey >> 9
    hy = (rkey & 511) - _Y_BIAS

    dy = hy - ly
    adx = jnp.minimum(hx, n2) - lx
    adx_safe = jnp.maximum(adx, 1)
    bins = jax.lax.broadcasted_iota(jnp.int32, (B, C, n2), 2)
    t = bins - lx
    off = (t * jnp.abs(dy)) // adx_safe
    y = ly + jnp.where(dy < 0, -off, off)
    y = jnp.where(has_right & (adx > 0), y, ly)
    y = jnp.clip(y, 0, 255)

    gains = jnp.take(idb_table, y)  # [B, C, n2]
    return jnp.where(has_floor[:, :, None], gains, jnp.float32(0.0))


def _apply_inverse_coupling(residue, coupling_steps):
    """Inverse square-polar coupling over ``residue [B, C, n2]``.

    Step list is static and unrolled in reverse order
    (NVorbis/Mapping.cs:137-182).  Channels flagged do-not-decode carry
    all-zero residue, for which the transform is the identity, so no
    per-frame execute mask is needed.
    """
    for mag, ang in reversed(coupling_steps):
        m = residue[:, mag]
        a = residue[:, ang]
        m_pos = m > 0
        a_pos = a > 0
        new_m = jnp.where(m_pos, jnp.where(a_pos, m, m + a), jnp.where(a_pos, m, m - a))
        new_a = jnp.where(m_pos, jnp.where(a_pos, m - a, m), jnp.where(a_pos, m + a, m))
        residue = residue.at[:, mag].set(new_m).at[:, ang].set(new_a)
    return residue


def _floored_spectrum(residue, ys, used, has_floor, xs, coupling,
                      f0_curves=None, has_f0=False, sl=None):
    """Coupling + floor render + floor multiply; returns ``[B, C, n2]``."""
    n2 = residue.shape[-1]
    residue = _apply_inverse_coupling(residue, coupling)
    curve = _render_floor1_curves(
        xs, ys, used, has_floor, jnp.asarray(INVERSE_DB_TABLE), n2, sl=sl
    )
    if has_f0:
        # channels whose floor is Floor0 have no floor1 posts: xs[...,0] is
        # the pad value; substitute the host-rendered curve there
        floor1_mask = xs[..., 0] < _XS_PAD  # [C] or [B, C]
        if floor1_mask.ndim == 1:
            floor1_mask = floor1_mask[None]
        curve = jnp.where(floor1_mask[:, :, None], curve, f0_curves)
    return residue * curve


def synth_spectra(residue, ys, used, has_floor, xs, basis, coupling,
                  f0_curves=None, has_f0=False, sl=None):
    """Un-windowed synthesis body: coupling -> floor render -> floor
    multiply -> IMDCT matmul.  Returns PCM ``[B, C, n]``."""
    n2 = residue.shape[-1]
    n = basis.shape[-1]
    spectrum = _floored_spectrum(
        residue, ys, used, has_floor, xs, coupling,
        f0_curves=f0_curves, has_f0=has_f0, sl=sl,
    )
    with jax.named_scope("imdct"):
        return jnp.dot(
            spectrum.reshape(-1, n2),
            basis,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(residue.shape[0], residue.shape[1], n)


def synth_core(residue, ys, used, has_floor, window_index, xs, windows, basis,
               coupling, f0_curves=None, has_f0=False, sl=None):
    """The synthesis body (traceable, stream-agnostic): coupling -> floor
    render -> floor multiply -> IMDCT matmul -> window.  Returns windowed
    PCM ``[B, C, n]``."""
    pcm = synth_spectra(
        residue, ys, used, has_floor, xs, basis, coupling,
        f0_curves=f0_curves, has_f0=has_f0, sl=sl,
    )
    with jax.named_scope("window"):
        win = jnp.take(windows, window_index, axis=0)  # [B, n]
        return pcm * win[:, None, :]


@functools.partial(jax.jit, static_argnames=("coupling", "st"))
def _synth_program_sym(
    classes, ids_flat, frame_base, ys, used, has_floor, window_index,
    xs, windows, basis, sl, g_t, pr_t, mg_t, *, coupling, st,
):
    """Jitted symbol-mode synthesis: residues arrive as classes + canonical
    VQ entry ids and are rebuilt on device (synth/residue_sym.py) before the
    shared synthesis body."""
    from nvorbis_tpu.synth.residue_sym import reconstruct_spectrum

    residue = reconstruct_spectrum(
        classes, ids_flat, frame_base, (g_t, pr_t, mg_t), st,
        ys.shape[1],
    )
    return synth_core(
        residue, ys, used, has_floor, window_index, xs, windows, basis,
        coupling, sl=sl,
    )


@functools.partial(jax.jit, static_argnames=("coupling", "has_f0"))
def _synth_program(
    residue, ys, used, has_floor, window_index, f0_curves, xs, windows, basis,
    sl, *, coupling, has_f0,
):
    """Jitted wrapper of :func:`synth_core`.

    All per-stream tables (floor X positions, bin map, window set, IMDCT
    basis) are *arguments*, so the jit cache is shared across every
    stream/reader with the same shapes and coupling topology — opening a new
    file never recompiles.
    """
    return synth_core(
        residue, ys, used, has_floor, window_index, xs, windows, basis,
        coupling, f0_curves=f0_curves, has_f0=has_f0, sl=sl,
    )


class DeviceSynth:
    """Batched synthesis front-end for one (setup, mode) pair.

    Holds the stream's device-resident constant tables (floor X positions,
    windows, IMDCT basis) and feeds them to the shared jitted
    :func:`_synth_program`.
    """

    def __init__(self, setup, mode, max_posts=None):
        from nvorbis_tpu.utils.jaxinit import ensure_compile_cache

        ensure_compile_cache()
        self.mode = mode
        mapping = mode.mapping
        self.channels = setup.channels
        self.n = mode.block_size
        self.n2 = self.n // 2
        self.coupling_steps = tuple(zip(mapping.coupling_mag, mapping.coupling_ang))

        # per-channel floor config (static for a given mode/mapping)
        floors = [setup.floors[mapping.channel_floor[c]] for c in range(self.channels)]
        self.floor1_mask = np.array([isinstance(f, Floor1) for f in floors], dtype=bool)
        self.has_floor0 = bool((~self.floor1_mask).any())

        if max_posts is None:
            max_posts = 1
            for f in floors:
                if isinstance(f, Floor1):
                    max_posts = max(max_posts, f.post_count)
        self.max_posts = max_posts

        xs = np.full((self.channels, max_posts), _XS_PAD, dtype=np.int32)
        for c, f in enumerate(floors):
            if isinstance(f, Floor1):
                xs[c, : f.post_count] = f.xs_sorted
        self._xs = xs

        self._sl = floor1_bin_map(xs, self.n2)  # [C, n2]
        self._windows = np.stack(mode.windows).astype(np.float32)  # [W, n]
        self._basis = imdct_basis(self.n, np.float32)  # [n2, n]
        self._dev_tabs = None

    def _ensure_dev(self):
        # device-resident constants, transferred once per stream (lazily,
        # at first dispatch)
        if self._dev_tabs is None:
            self._dev_tabs = (
                jnp.asarray(self._xs), jnp.asarray(self._sl),
                jnp.asarray(self._windows), jnp.asarray(self._basis),
            )
        return self._dev_tabs

    @property
    def _xs_dev(self):
        return self._ensure_dev()[0]

    @property
    def _sl_dev(self):
        return self._ensure_dev()[1]

    @property
    def _windows_dev(self):
        return self._ensure_dev()[2]

    @property
    def _basis_dev(self):
        return self._ensure_dev()[3]

    # -- program ------------------------------------------------------------

    def make_fn(self):
        """Pure batched synthesis closure over this stream's tables
        (for the driver's single-chip compile check)."""
        xs, windows, basis = self._xs_dev, self._windows_dev, self._basis_dev
        sl = self._sl_dev
        coupling = self.coupling_steps
        has_f0 = self.has_floor0

        def synth(residue, ys, used, has_floor, window_index, f0_curves):
            return _synth_program(
                residue, ys, used, has_floor, window_index, f0_curves,
                xs, windows, basis, sl, coupling=coupling, has_f0=has_f0,
            )

        return synth

    @staticmethod
    def _bucket(b: int) -> int:
        """Padded frame-batch extent (min 16): the shared shape grid
        (engine/plan.pad_quantum — <=25% padded rows, bounded recompiles;
        NVT_PAD_POW2=1 reverts to pure pow2)."""
        from nvorbis_tpu.engine.plan import pad_quantum

        return pad_quantum(b, 16)

    def attach_symbol_plan(self, plan):
        """Enable :meth:`dispatch_sym` with a ResiduePlan for this mode's
        residue (see synth/residue_sym.py)."""
        from nvorbis_tpu.synth.residue_sym import plan_static, plan_tables_dev

        self._sym_static = plan_static(plan, self.n)
        self._sym_tabs = plan_tables_dev(plan)

    def dispatch_sym(self, classes, ids_flat, frame_base, ys, used,
                     has_floor, window_index):
        """Symbol-mode async dispatch; same contract as :meth:`dispatch`
        but residues arrive as classes + flat canonical entry ids."""
        from nvorbis_tpu.synth.residue_sym import round_ids

        b = classes.shape[0]
        bp = self._bucket(b)
        if bp != b:
            classes = np.pad(classes, [(0, bp - b), (0, 0), (0, 0)],
                             constant_values=255)
            frame_base = np.pad(frame_base, [(0, bp - b)])
            ys = np.pad(ys, [(0, bp - b), (0, 0), (0, 0)])
            used = np.pad(used, [(0, bp - b), (0, 0), (0, 0)])
            has_floor = np.pad(has_floor, [(0, bp - b), (0, 0)])
            window_index = np.pad(window_index, [(0, bp - b)])
        n_pad = round_ids(ids_flat.shape[0])
        if n_pad != ids_flat.shape[0]:
            ids_flat = np.pad(ids_flat, [(0, n_pad - ids_flat.shape[0])],
                              constant_values=-1)
        out = _synth_program_sym(
            jnp.asarray(classes.astype(np.int32)),
            jnp.asarray(ids_flat),
            jnp.asarray(frame_base),
            jnp.asarray(ys),
            jnp.asarray(used),
            jnp.asarray(has_floor),
            jnp.asarray(window_index),
            self._xs_dev,
            self._windows_dev,
            self._basis_dev,
            self._sl_dev,
            *self._sym_tabs,
            coupling=self.coupling_steps,
            st=self._sym_static,
        )
        return out, b

    def dispatch(self, residue, ys, used, has_floor, window_index, f0_curves=None):
        """Dispatch a batch asynchronously; returns ``(device_array, b)``.

        Inputs are padded up to a coarse bucket size (padding frames decode
        to silence).  The result is a live jax array — conversion to numpy
        (and thus the device sync) is deferred to the caller so host unpack
        of the next window overlaps device compute.
        """
        b = residue.shape[0]
        bp = self._bucket(b)
        if bp != b:
            pad = [(0, bp - b)] + [(0, 0)] * (residue.ndim - 1)
            residue = np.pad(residue, pad)
            ys = np.pad(ys, [(0, bp - b), (0, 0), (0, 0)])
            used = np.pad(used, [(0, bp - b), (0, 0), (0, 0)])
            has_floor = np.pad(has_floor, [(0, bp - b), (0, 0)])
            window_index = np.pad(window_index, [(0, bp - b)])
            if f0_curves is not None:
                f0_curves = np.pad(f0_curves, [(0, bp - b), (0, 0), (0, 0)])
        if f0_curves is None:
            f0_curves = np.zeros((1, 1, 1), dtype=np.float32)
            if self.has_floor0:
                f0_curves = np.zeros((bp, self.channels, self.n2), dtype=np.float32)
        out = _synth_program(
            jnp.asarray(residue),
            jnp.asarray(ys),
            jnp.asarray(used),
            jnp.asarray(has_floor),
            jnp.asarray(window_index),
            jnp.asarray(f0_curves),
            self._xs_dev,
            self._windows_dev,
            self._basis_dev,
            self._sl_dev,
            coupling=self.coupling_steps,
            has_f0=self.has_floor0,
        )
        return out, b

    def __call__(self, residue, ys, used, has_floor, window_index, f0_curves=None):
        """Synchronous convenience wrapper: numpy in, numpy ``[B, C, n]`` out."""
        out, b = self.dispatch(residue, ys, used, has_floor, window_index, f0_curves)
        return np.asarray(out)[:b]
