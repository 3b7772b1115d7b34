"""Kernel-level ops: the traceable device-plane building blocks.

Each op is a pure function over dense tensors, usable standalone under
``jax.jit``/``vmap`` or composed as in ``synth/device.py``'s fused program.
They are the device-plane equivalents of the reference's per-frame DSP
routines (see each function's docstring for the NVorbis file:line mapping).
"""

from nvorbis_tpu.synth.device import (
    synth_core,
    synth_spectra,
    floor1_bin_map,
    _apply_inverse_coupling as apply_inverse_coupling,
    _render_floor1_curves as render_floor1_curves,
)
from nvorbis_tpu.synth.oracle import imdct_basis
from nvorbis_tpu.synth.residue_sym import reconstruct_spectrum
from nvorbis_tpu.codec.mode import calc_window, calc_overlap

__all__ = [
    "synth_core",
    "synth_spectra",
    "floor1_bin_map",
    "apply_inverse_coupling",
    "render_floor1_curves",
    "imdct_basis",
    "reconstruct_spectrum",
    "calc_window",
    "calc_overlap",
]
