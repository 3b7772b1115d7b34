"""Profile the synthesis program at the long-block stereo chunk shape.

Runs ``synth/device._synth_program`` (floor render + coupling + IMDCT
matmul at ``Precision.HIGHEST`` + window) on real n = 2048 stereo frames,
takes a ``jax.profiler`` trace of a steady window and reduces it to:

- each GPU kernel's total device time and its share of the program;
- the IMDCT matmul's time against the card's float32 roofline (the larger
  of FLOPs over the FP32 peak and bytes over the HBM peak);
- whether XLA fused the window multiply into the matmul's kernel, read
  from the optimized HLO (saved next to the trace).

Usage: python tools/trace_synth.py [frames] [out_dir]
Needs the GPU.  ``out_dir`` defaults to ``.benchcache/trace_synth``.
"""

import glob
import json
import os
import re
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402

# published dense peaks (NVIDIA H100 SXM data sheet; float32 outside the
# tensor cores), keyed by jax's device_kind; an unlisted device is an error
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def reduce_trace(trace_dir):
    """{kernel name: (total device ns, count, hlo_op)} over the GPU stream
    lines of the newest ``.xplane.pb`` under ``trace_dir``."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(
        trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    pd = ProfileData.from_file(path)
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                tot, cnt, op = out.get(ev.name, (0.0, 0, None))
                out[ev.name] = (tot + ev.duration_ns, cnt + 1,
                                op or stats.get("hlo_op"))
    return out


def main():
    import jax

    from chip_smoke import stream_frames
    from nvorbis_tpu.synth.device import DeviceSynth, _synth_program
    from nvorbis_tpu.testgen.corpus import long_stream
    from nvorbis_tpu.utils import devinfo

    if jax.default_backend() != "gpu":
        sys.exit(f"trace_synth needs the GPU; jax backend is "
                 f"{jax.default_backend()!r}")
    kind = jax.devices()[0].device_kind
    peak = PEAKS[kind]
    card = devinfo.card()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    out_dir = (sys.argv[2] if len(sys.argv) > 2
               else os.path.join(_REPO, ".benchcache", "trace_synth"))
    os.makedirs(out_dir, exist_ok=True)

    setup, mode, max_posts, residue, ys, used, has_floor, widx = (
        stream_frames(long_stream(4), 2048, B))
    synth = DeviceSynth(setup, mode, max_posts=max_posts)
    C, n2, n = residue.shape[1], residue.shape[2], mode.block_size
    args = [jax.device_put(a) for a in (
        residue, ys, used, has_floor, widx, np.zeros((1, 1, 1), np.float32))]
    kw = dict(coupling=synth.coupling_steps, has_f0=False)
    tabs = (synth._xs_dev, synth._windows_dev, synth._basis_dev,
            synth._sl_dev)

    compiled = _synth_program.lower(*args, *tabs, **kw).compile()
    hlo = compiled.as_text()
    with open(os.path.join(out_dir, "synth_program.hlo.txt"), "w") as f:
        f.write(hlo)
    print(f"memory_analysis: {compiled.memory_analysis()}")

    for _ in range(5):  # warm
        jax.block_until_ready(_synth_program(*args, *tabs, **kw))
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        out = _synth_program(*args, *tabs, **kw)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / reps

    trace_dir = os.path.join(out_dir, "trace")
    with jax.profiler.trace(trace_dir):
        for _ in range(reps):
            out = _synth_program(*args, *tabs, **kw)
        jax.block_until_ready(out)
    kernels = reduce_trace(trace_dir)
    total = sum(v[0] for v in kernels.values())

    flops = 2.0 * B * C * n2 * n
    mm_bytes = 4.0 * (B * C * n2 + n2 * n + B * C * n)
    t_min = max(flops / peak["fp32_flops"], mm_bytes / peak["hbm_bytes"])
    matmul = {k: v for k, v in kernels.items()
              if re.search(r"gemm|xmma|cutlass|sm90|dot|matmul", k, re.I)}
    mm_ns = sum(v[0] for v in matmul.values()) / reps

    print(f"card: {card}; device_kind: {kind}; frames B={B} C={C} n={n}")
    print(f"wall per call (host clock, {reps} calls): {wall * 1e3:.3f} ms")
    print(f"device time per call (trace): {total / reps / 1e6:.3f} ms")
    for name, (ns, cnt, op) in sorted(kernels.items(),
                                      key=lambda kv: -kv[1][0]):
        print(f"  {ns / reps / 1e3:9.1f} us/call {100 * ns / total:5.1f}%  "
              f"x{cnt // reps}  {name[:90]}  [hlo_op={op}]")
    print(f"matmul: {mm_ns / 1e3:.1f} us/call, {flops / 1e9:.2f} GFLOP, "
          f"{flops / mm_ns / 1e3 if mm_ns else 0:.1f} TFLOP/s; roofline "
          f"minimum {t_min * 1e6:.1f} us (fp32 "
          f"{peak['fp32_flops'] / 1e12:.0f} TFLOP/s, HBM "
          f"{peak['hbm_bytes'] / 1e12:.2f} TB/s) -> roofline share "
          f"{t_min * 1e9 / mm_ns if mm_ns else 0:.3f}")
    # the window multiply: the entry computation's instruction that
    # consumes the matmul's result
    entry = hlo[hlo.index("ENTRY"):]
    print("entry computation:")
    for ln in entry.splitlines()[1:40]:
        print("  " + ln.strip()[:160])
    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump({"card": card, "device_kind": kind, "B": B, "reps": reps,
                   "kernels": {k: [v[0], v[1], v[2]]
                               for k, v in kernels.items()}}, f, indent=1)
    print(f"  [{card}]")


if __name__ == "__main__":
    main()
