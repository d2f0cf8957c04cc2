"""The exact likelihood's bf16 error, path by path.

    python3 -m gecco_tpu_torch.probes.logp      # from the repo's root, on the card

For the conditional model and the flagship (6 x 384, seeded init, bf16, as
``chip_smoke.py`` builds them) this runs ``evaluate_logp_from`` on one
Rademacher draw over a 4-step grid at batch 8 and 2048 points on four
paths: the kernel path, the plain path, the set-transformer kernels with
the plain gather, and the plain set transformer with the gather kernels;
then the plain path of the same weights in fp32. It prints each bf16
path's max |err| / max |ref| per ``LogpDetails`` field against the fp32
path and against the bf16 plain path, so that a departure of the kernel
path can be told from the bf16 error both paths share. Needs the card.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

FIELDS = ("logp", "prior_logp", "delta_reparam", "delta_jacobian", "latent", "trajectory_diff")
# (attn_impl, lookup_impl) of each bf16 path
PATHS = {"kernel": ("folded_pallas", "pallas"), "plain": ("xla", "xla"),
         "attention kernels, plain gather": ("folded_pallas", "xla"),
         "plain attention, gather kernels": ("xla", "pallas")}


def rel(a, ref) -> float:
    """max |a - ref| / max |ref| over the entries finite in both."""
    m = torch.isfinite(a) & torch.isfinite(ref)
    return float((a[m] - ref[m]).abs().max() / ref[m].abs().max().clamp_min(1e-30))


def run_paths(which: str, dev) -> dict:
    """{(dtype, path): LogpDetails} for one model."""
    import chip_smoke as cs

    out = {}
    eps = torch.randint(0, 2, (1, 8, 2048, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(8)) * 2.0 - 1.0
    for dt in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(0)
        if which == "conditional":
            model = cs.build_conditional(dev, gen, 6, dt=dt)
            (data, raw), = cs.conditional_batches(dev, 1, 8, 2048, cs.IMAGE_SIZE, seed=6)
        else:
            model = cs.build_flagship(dev, gen, 6, dt=dt)
            data = torch.from_numpy(cs.make_clouds(np.random.default_rng(7), 8, 2048)).to(dev)
            raw = None
        paths = PATHS if dt == torch.bfloat16 else {"plain": PATHS["plain"]}
        for name, (attn, lookup) in paths.items():
            model.network.backbone.attn_impl = attn
            if hasattr(model.network, "lookup_impl"):
                model.network.lookup_impl = lookup
            out[(str(dt).split(".")[-1], name)] = model.evaluate_logp_from(
                data, eps, raw_ctx=raw, n_solver_steps=4, return_details=True)
        del model
    return out


def main():
    import sys

    sys.path.insert(0, ".")
    if not torch.cuda.is_available():
        raise SystemExit("probes.logp: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    for which in ("conditional", "flagship"):
        out = run_paths(which, dev)
        fp32, plain = out[("float32", "plain")], out[("bfloat16", "plain")]
        for key, d in out.items():
            if key[0] == "float32":
                continue
            errs = ", ".join(f"{f} {rel(getattr(d, f), getattr(fp32, f)):.2e} / "
                             f"{rel(getattr(d, f), getattr(plain, f)):.2e}" for f in FIELDS)
            print(f"{which} {key[1]} (bf16), against the fp32 plain path / the bf16 plain "
                  f"path: {errs}")


if __name__ == "__main__":
    main()
