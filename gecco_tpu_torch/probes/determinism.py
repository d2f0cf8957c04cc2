"""Which of the flagship's kernels give the same bits from call to call.

    python3 -m gecco_tpu_torch.probes.determinism

Calls each fused set-transformer wrapper (pool, h-side, unpool, MLP) three
times at the flagship's training shapes (B 48, N 2048, C 384, 8 heads, 64
inducers, W 768; ordinary and drifted operands from ``chip_smoke.py``'s
functions) with the same operands and one fixed cotangent, and prints for
each output and input gradient whether calls 2 and 3 are the same bits as
call 1 and the largest difference; then the flagship's loss and gradients
at one batch and draw, three times, and its ``denoise``. Outputs that add
in fp32 atomics (the unpool's channel sums, the pool backward's dse, dbe,
dWo and dWv) vary at their rounding. Run from the repository's root.
Needs the card.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.ops.kernels import hside as hs

B, N, C, H, I, W = 48, 2048, 384, 8, 64, 768
NAMES = {
    "pool_ext": ("h0", "dx", "dse", "dbe", "dind2", "dkvw", "dwo"),
    "hside": ("h", "k", "v", "dh0", "ds1", "db1n", "ds2", "db2n", "dw1t", "db1", "dw2t", "db2",
              "dwk", "dwv"),
    "unpool": ("out", "sums", "dx", "dse", "dbe", "dk", "dv", "dwq", "dwo"),
    "mlp": ("out", "sums", "dx", "dse", "dbe", "dw1t", "db1", "dw2t", "db2"),
}


def repeat(fn, ops, device, calls=3) -> list:
    """``calls`` calls of ``fn`` on copies of ``ops``: per call the outputs,
    then the gradients of one fixed linear function of them."""
    runs = []
    for _ in range(calls):
        xs = [o.detach().clone().requires_grad_(o.is_floating_point() and o.dim() > 0)
              for o in ops]
        out = fn(*xs)
        outs = [o for o in (out if isinstance(out, tuple) else (out,))
                if isinstance(o, torch.Tensor)]
        loss = sum((o.float() * torch.linspace(-1, 1, o.numel(), device=device)
                    .reshape(o.shape)).sum() for o in outs)
        wrt = [x for x in xs if x.requires_grad]
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        runs.append([o.detach() for o in outs] + [g.detach() for g in grads if g is not None])
    return runs


def report(name, runs, labels) -> None:
    first = runs[0]
    for q, label in enumerate(labels[:len(first)]):
        same = [torch.equal(first[q], r[q]) for r in runs[1:]]
        diff = max(float((first[q].float() - r[q].float()).abs().max()) for r in runs[1:])
        print(f"  {name} {label}: the same bits {same}, largest difference {diff:.3g}",
              flush=True)


def main() -> None:
    import chip_smoke as s

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    s._build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    bf = torch.bfloat16
    for drift in (False, True):
        g = torch.Generator(device=device).manual_seed(5)
        cases = (
            ("pool_ext", lambda *a: fa.folded_pool_ext(*a, H),
             s.pool_operands(g, B, N, C, H, I, drift, device, bf)),
            ("hside", hs.fused_h_side, s.hside_operands(g, B, I, C, W, drift, device, bf)),
            ("unpool", lambda *a: fa.folded_unpool(*a, H, True, True),
             s.unpool_operands(g, B, N, C, H, I, drift, device, bf)),
            ("mlp", fa.fused_mlp_residual, s.mlp_operands(g, B, N, C, W, drift, device, bf)),
        )
        for name, fn, ops in cases:
            report(f"{name}{' [drift]' if drift else ''}", repeat(fn, ops, device), NAMES[name])

    model = s.build_flagship(device, torch.Generator().manual_seed(0), 6)
    pts = torch.from_numpy(s.make_clouds(np.random.default_rng(0), B, N)).to(device)
    sigma, noise = model.draw_sigma_noise(torch.Generator(device=device).manual_seed(1), pts)
    losses, grads = [], []
    for _ in range(3):
        model.zero_grad(set_to_none=True)
        loss = model.loss_from(pts, sigma, noise)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    differ = [sum(not torch.equal(grads[0][k], gr[k]) for k in gr) for gr in grads[1:]]
    print(f"  flagship loss at one batch and draw, three times: {losses}; parameters whose "
          f"gradient differs from the first: {differ} of {len(grads[0])}", flush=True)
    with torch.no_grad():
        x = torch.randn(B, N, 3, generator=torch.Generator(device=device).manual_seed(2),
                        device=device)
        outs = [model.denoise(torch.full((B,), 3.0, device=device), x) for _ in range(3)]
    print(f"  flagship denoise the same bits in calls 2, 3: "
          f"{[torch.equal(outs[0], o) for o in outs[1:]]}", flush=True)


if __name__ == "__main__":
    main()
