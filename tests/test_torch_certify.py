"""The port's kernel certifier (``gecco_tpu_torch.certify``, the
counterpart of ``scripts/certify_kernels.py``) on the CPU: its operand
statistics against the script's, a clean pass at a tiny shape (on the CPU
every wrapper is its plain version), the model arm at a checkpoint's
``ema.pt``, and a nonzero exit for each planted fault: a plain version
perturbed by 10%, and a wrapper that returns a NaN."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu_torch import certify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--cpu", "--batch", "2", "--n-points", "128", "--width-c", "64", "--inducers", "16",
        "--heads", "4", "--mlp-width", "128", "--seeds", "1"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _script():
    spec = importlib.util.spec_from_file_location(
        "certify_kernels", os.path.join(REPO, "scripts", "certify_kernels.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("gain", [1.0, 5.0, 12.0])
def test_head_factors_and_logit_stats_match_the_script(gain):
    script = _script()
    for heads in (4, 8):
        ours = certify._head_factors(np.random.default_rng(3), heads, gain)
        ref = script._head_factors(np.random.default_rng(3), heads, gain)
        np.testing.assert_array_equal(ours, np.asarray(ref))
    logits = (gain * np.random.default_rng(0).standard_normal((2, 16, 8 * 4))).astype(np.float32)
    for given in (logits, logits.reshape(2, 16, 8, 4)):
        ref = script._logit_stats(jnp.asarray(given), 8)
        assert certify._logit_stats(given, 8) == ref
        assert certify._logit_stats(torch.from_numpy(given), 8) == ref


def test_certify_passes_at_a_tiny_shape(capsys):
    assert certify.main(TINY + ["--gains", "1", "12"]) == 0
    rows = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith(("PASS", "FAIL"))]
    assert len(rows) == 10 and all(r.startswith("PASS") for r in rows)
    assert '"kernel": "pool_ext", "gain": 12.0' in "\n".join(rows)
    assert "head_max_spread" in rows[0]


def test_model_arm_reads_the_trainers_ema(tmp_path, capsys):
    from gecco_tpu_torch import Diffusion, GaussianReparam, LogUniformSchedule
    from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork

    gen = torch.Generator().manual_seed(1)
    backbone = SetTransformer(1, 64, 16, embed_dim=1, num_heads=4, compute_dtype=torch.bfloat16,
                              attn_impl="folded_pallas", device="cpu", generator=gen)
    net = UnconditionalPointNetwork(backbone, 64, device="cpu", generator=gen)
    model = Diffusion(net, LogUniformSchedule(sigma_max=165.0), reparam=GaussianReparam(
        [0.0] * 3, [0.35] * 3, device="cpu"))
    ckpt = tmp_path / "checkpoint-step-9"
    ckpt.mkdir()
    torch.save(model.state_dict(), ckpt / "ema.pt")
    out = tmp_path / "rows.jsonl"
    argv = TINY + ["--gains", "1", "--only", "mlp", "--layers", "1", "--out", str(out)]
    assert certify.main(argv + ["--ema", str(tmp_path)]) == 0
    assert f"EMA weights from {ckpt / 'ema.pt'}" in capsys.readouterr().out
    assert [line.count('"kernel": "MODEL"') for line in out.read_text().splitlines()] == [0, 1]


@pytest.mark.parametrize("fault", ["plain_off_by_10pct", "fused_nan"])
def test_a_planted_fault_fails_the_certifier(monkeypatch, capsys, fault):
    if fault == "plain_off_by_10pct":
        plain = certify.PLAIN["pool_ext"]
        monkeypatch.setitem(certify.PLAIN, "pool_ext", lambda *a, h: 1.1 * plain(*a, h=h))
    else:
        fused = certify.FUSED["pool_ext"]

        def nan_fused(*a, h):
            out = fused(*a, h=h)
            return out + torch.where(torch.arange(out.numel()).reshape(out.shape) == 5,
                                     float("nan"), 0.0).to(out.dtype)

        monkeypatch.setitem(certify.FUSED, "pool_ext", nan_fused)
    assert certify.main(TINY + ["--gains", "1", "--only", "pool_ext,mlp"]) == 1
    rows = capsys.readouterr().out.splitlines()
    assert any(r.startswith('FAIL {"kernel": "pool_ext"') for r in rows)
    assert any(r.startswith('PASS {"kernel": "mlp"') for r in rows)
