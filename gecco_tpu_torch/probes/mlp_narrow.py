"""Where the narrow MLP forward's time goes (``csrc/mlp_narrow.cu``, the
upsample demo's C 128, W 256), by text-edited copies of its source.

    python3 -m gecco_tpu_torch.probes.mlp_narrow

Each variant is a copy of ``csrc/mlp_narrow.cu`` with one edit, built under
``gecco_tpu_torch/_build/probe_mlp_narrow/``:

- ``exp2f``: g = bf16(exp2f(-log2(e) / 2 h^2)) in place of bf16(expf(-h^2 /
  2)), a correct variant whose g may round apart by a bf16 step;
- ``no_exp``: g = bf16(h + b1), timing only (no exponential);
- ``no_sums``: the epilogue's column sums never written to the staging
  buffer (what the compiler then drops is its own), timing only;
- ``no_second``: the second product skipped (o stays 0), timing only.

At the demo's shapes (B 48, N 2048) the shipped body and ``exp2f`` are held
against the plain version and must be the same bits in two calls; then
every variant is timed in the order shipped, variants, variants reversed,
shipped (CUDA events, median of 20 calls a turn) and its device time read
by ``torch.profiler``. Prints the card's name and power limit and one JSON
line. Needs the card.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys

import torch

from gecco_tpu_torch.ops.kernels import _build
from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.probes.pool_bwd import launch_split

_EXP = "        ga[m] = pack2(expf(-0.5f * h0 * h0), expf(-0.5f * h1 * h1));"
VARIANTS = {
    "exp2f": ((_EXP, "        ga[m] = pack2(exp2f(-0.72134752f * h0 * h0), "
                     "exp2f(-0.72134752f * h1 * h1));"),),
    "no_exp": ((_EXP, "        ga[m] = pack2(h0, h1);"),),
    "no_sums": (("      if (lane < 4) {\n        red[warp * kC + c] = s00;",
                 "      if (lane > 32) {\n        red[warp * kC + c] = s00;"),),
    "no_second": (("        rect::wgmma_rs_t(o, kstep32(ga, ks),",
                   "        if (W < 0) rect::wgmma_rs_t(o, kstep32(ga, ks),"),),
}
CORRECT = ("shipped", "exp2f")


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the probe's edit no longer matches csrc: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    """One library per variant, all compiled at once."""
    src = _build.BUILD_DIR / "probe_mlp_narrow"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    shipped = (src / "mlp_narrow.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        (src / f"{name}.cu").write_text(_edit(shipped, edits))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
               str(src / f"lib{name}.so"), str(src / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(src / f"lib{name}.so"))
        libs[name].mlp_narrow_launch.restype = ctypes.c_int
    return libs


def variant_mlp(lib, x, se, be, w1t, b1, w2t, b2):
    """``fused_mlp_residual`` through a variant library (N a multiple of
    128) -> (out, sums)."""
    b, n, c = x.shape
    w = w1t.shape[1]
    out = torch.empty_like(x)
    sums = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    part = torch.empty((b * n // 128, 2, c), dtype=torch.float32, device=x.device)
    args = (x, se, be, w1t, b1, w2t, b2, part, out, sums, b, n, c, w, n)
    err = lib.mlp_narrow_launch(*[_build._arg(a) for a in args],
                                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"mlp_narrow_launch: CUDA error {err}")
    return out, sums


def times_ms(fn, reps=20, warmup=3) -> list:
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("mlp_narrow: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build_variants()
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    b, n, c, w = 48, 2048, 128, 256
    bf = torch.bfloat16
    ops = (r(b, n, c).to(bf), 1.0 + 0.1 * r(b, c), 0.1 * r(b, c), (r(c, w) / c**0.5).to(bf),
           0.1 * r(1, w), (r(w, c) / w**0.5).to(bf), 0.1 * r(1, c))
    runs = {"shipped": lambda: fa._mlp_narrow(*ops)}
    runs.update({name: (lambda lib=lib: variant_mlp(lib, *ops)) for name, lib in libs.items()})
    want = fa._mlp_ref(*ops)
    ok = True
    record = {"errors": {}}
    for name in CORRECT:
        got, again = runs[name](), runs[name]()
        torch.cuda.synchronize()
        err = [float((a.float() - q.float()).abs().max() / q.float().abs().max())
               for a, q in zip(got, want)]
        same = all(torch.equal(p, q) for p, q in zip(got, again))
        ok &= err[0] < 2e-2 and err[1] < 1e-2 and same
        record["errors"][name] = dict(out=err[0], sums=err[1], same_bits=same)
        print(f"{name}: out {err[0]:.3e}, sums {err[1]:.3e} of max |ref|, two calls "
              f"{'the same bits' if same else 'DIFFER'}")
    order = list(runs) + list(runs)[::-1]
    times = {name: [] for name in runs}
    for name in order:
        times[name] += times_ms(runs[name])
    for name, fn in runs.items():
        split = launch_split(fn)
        record[name] = dict(ms=statistics.median(times[name]), device_ms=sum(split.values()),
                            kernel_device_ms=split.get("mlp_narrow_kernel"))
        print(f"{name}: {record[name]}")
    print(json.dumps({"mlp_narrow": record, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
