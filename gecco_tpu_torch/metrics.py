"""Validation metrics and set-to-set distances (counterpart of
``gecco_tpu/metrics.py``: ``Metric``, ``LossMetric``, ``LogpMetric``,
``SupervisedMetric``, the Chamfer distances and the earth mover's
distances). A metric is called as ``metric(model, points, raw_ctx,
generator)`` and returns a dict of per-batch tensors under the JAX
package's keys.

The distances take point sets ``[..., N, D]`` whose leading axes broadcast
(the JAX package ``vmap``s its unbatched EMDs over them). The exact EMD
comes in two forms: ``scipy_emd`` solves each pair's assignment with
scipy's Hungarian on the host, ``auction_emd`` on the tensors' device with
the eps-scaling Jacobi auction (Bertsekas 1988) of the JAX package, every
pair of the batch in one loop; ``sinkhorn_emd`` is the entropy-regularised
transport cost by log-domain Sinkhorn with uniform marginals."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from gecco_tpu_torch.geometry import distance_matrix

__all__ = [
    "Metric",
    "LossMetric",
    "LogpMetric",
    "SupervisedMetric",
    "auction_emd",
    "auction_lsa",
    "chamfer_distance",
    "chamfer_distance_squared",
    "scipy_emd",
    "sinkhorn_emd",
]


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, squared: bool = False) -> torch.Tensor:
    """Symmetric Chamfer distance, ``[..., N, D] x [..., M, D] -> [...]``:
    the mean of the two directions' mean nearest-neighbour distances."""
    dist_m = distance_matrix(a, b, squared=squared)
    min_a = dist_m.amin(dim=-2).mean(dim=-1)
    min_b = dist_m.amin(dim=-1).mean(dim=-1)
    return (min_a + min_b) / 2


def chamfer_distance_squared(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return chamfer_distance(a, b, squared=True)


def _squared(metric: str) -> bool:
    return {"l1": False, "l2": True}[metric]


def _matched_mean(p1, p2, match_dist, cols, match: str, average: str) -> torch.Tensor:
    """The mean over the rows of the ``average`` distance between row i and
    its matched column ``cols[..., i]``: [...]. Gradients flow through the
    distances with the assignment held fixed."""
    if _squared(average) == _squared(match):
        average_dist = match_dist
    else:
        average_dist = distance_matrix(p1, p2, squared=_squared(average))
    return average_dist.gather(-1, cols[..., None]).squeeze(-1).mean(-1)


def scipy_emd(p1: torch.Tensor, p2: torch.Tensor, match: str = "l1",
              average: str = "l1") -> torch.Tensor:
    """Exact EMD: each pair's optimal assignment under the ``match``
    distance by scipy's ``linear_sum_assignment`` on the host, then the mean
    ``average`` distance over the matched pairs. ``[..., N, D]`` sets of
    equal N -> [...]."""
    from scipy.optimize import linear_sum_assignment

    match_dist = distance_matrix(p1, p2, squared=_squared(match))
    n = match_dist.shape[-1]
    costs = match_dist.detach().float().cpu().numpy().reshape(-1, n, n)
    cols = np.stack([linear_sum_assignment(c)[1] for c in costs]).astype(np.int64)
    cols = torch.from_numpy(cols).to(match_dist.device)
    return _matched_mean(p1, p2, match_dist, cols.reshape(match_dist.shape[:-1]), match, average)


# iterations of an auction phase between two host reads of how many
# persons are unassigned (on the card: one CUDA graph's replay)
_AUCTION_CHECK_EVERY = 32
# whether the card replays captured iterations (False: issued one by one,
# as on the CPU; the chip script holds the two against each other)
_AUCTION_GRAPHS = True


class _Auction:
    """The Jacobi auction's state over a batch ``benefit [P, n, n]``
    (person, object), kept in place in fixed tensors: person -> object and
    object -> person (-1: none), the prices, each pair's iteration count
    in the phase and its eps.

    ``step(cap)`` is one iteration: every unassigned person of an active
    pair (some person unassigned, fewer than ``max_iters`` iterations in
    the phase) bids on its best object, ``v1 - v2 + eps`` over the price
    (the raise floored at ~2 fp32 ulps of the price, so that tied bidders
    make progress once eps is below the ulp), and each object takes its
    highest bid, the first bidder among equal ones; an inactive pair stays
    as it is. It computes the values of the unassigned persons only, the
    rows the JAX package's dense iteration takes its bids from, gathered
    into ``cap`` rows without a host sync (padding rows bid nothing). Their
    count never grows within a phase (an object bid on takes one winner,
    who held nothing, and frees at most one owner), so the count read on
    the host bounds the rows of every later iteration of the phase. On the
    card ``_AUCTION_CHECK_EVERY`` iterations at one ``cap`` (rounded up to
    a power of two) are captured once as a CUDA graph and replayed: an
    iteration is ~35 small kernels, which the host would otherwise issue
    one by one."""

    def __init__(self, benefit: torch.Tensor, max_iters: int):
        p_, n, _ = benefit.shape
        dev = benefit.device
        self.n, self.total, self.max_iters = n, p_ * n, max_iters
        self.rows_of = benefit.reshape(p_ * n, n)
        self.iota = torch.arange(n, device=dev)
        self.flat_iota = torch.arange(p_ * n, device=dev)
        self.pad = torch.full((p_, 1), -1, dtype=torch.long, device=dev)
        self.person_obj = torch.full((p_, n), -1, dtype=torch.long, device=dev)
        self.obj_person = torch.full((p_, n), -1, dtype=torch.long, device=dev)
        self.prices = torch.zeros((p_, n), device=dev)
        self.it = torch.zeros(p_, dtype=torch.long, device=dev)
        self.eps = torch.zeros(p_, device=dev)
        self.graphs = {}

    def bidders(self) -> tuple:
        active = (self.person_obj < 0).any(1) & (self.it < self.max_iters)
        return active, ((self.person_obj < 0) & active[:, None]).reshape(-1)

    def step(self, cap: int) -> None:
        n, total, dev = self.n, self.total, self.prices.device
        active, mask = self.bidders()
        slot = torch.where(mask, torch.cumsum(mask, 0) - 1, cap)
        rows = torch.full((cap + 1,), total, dtype=torch.long, device=dev).scatter_(
            0, slot, self.flat_iota)[:cap]
        valid = rows < total
        rows = rows.clamp_max(total - 1)
        pair, person = rows // n, rows % n
        prices = self.prices
        values = self.rows_of[rows] - prices[pair]  # [cap, n]
        j1 = values.argmax(1)
        if n > 1:
            v1, v2 = values.topk(2, dim=1).values.unbind(-1)
            # a -inf column: a unit raise
            v2 = torch.where(torch.isfinite(v2), v2, v1 - 1.0)
        else:
            v1 = values[:, 0]
            v2 = v1 - 1.0
        del values
        p = prices[pair, j1]
        bid = p + torch.maximum(v1 - v2 + self.eps[pair], p.abs() * 3e-7 + 1e-30)
        bid = torch.where(valid, bid, -math.inf)
        target = torch.where(valid, pair * n + j1, total)  # (pair, object), flat
        best_bid = torch.full((total + 1,), -math.inf, device=dev).scatter_reduce(
            0, target, bid, "amax")
        first = torch.where(valid & (bid == best_bid[target]), person, n)
        winner = torch.full((total + 1,), n, dtype=torch.long, device=dev).scatter_reduce(
            0, target, first, "amin")[:total].view_as(prices)
        best_bid = best_bid[:total].view_as(prices)
        has_bid = torch.isfinite(best_bid)
        prices.copy_(torch.where(has_bid, best_bid, prices))
        # the previous owner of every object bid on loses it; the winners
        # (all unassigned before) take theirs
        prev = torch.where(has_bid & (self.obj_person >= 0), self.obj_person, n)
        po = torch.cat([self.person_obj, self.pad], 1).scatter_(1, prev, -1)
        po.scatter_(1, torch.where(has_bid, winner, n), torch.where(has_bid, self.iota, -1))
        self.person_obj.copy_(po[:, :n])
        self.obj_person.copy_(torch.where(has_bid, winner, self.obj_person))
        self.it.add_(active.long())

    def run(self, cap: int) -> None:
        """``_AUCTION_CHECK_EVERY`` iterations at ``cap`` bidder rows."""
        k = _AUCTION_CHECK_EVERY
        if self.prices.device.type != "cuda" or not _AUCTION_GRAPHS:
            for _ in range(k):
                self.step(cap)
            return
        cap = 1 << (cap - 1).bit_length()
        graph = self.graphs.get(cap)
        if graph is None:
            self.step(cap)  # warm-up: a real iteration, outside the capture
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(k):
                    self.step(cap)
            self.graphs[cap] = graph
        graph.replay()

    def phase(self, eps: torch.Tensor) -> torch.Tensor:
        """One eps phase from no assignment, the prices carried over ->
        person -> object [P, n], -1 where a capped phase left a person
        unassigned."""
        self.person_obj.fill_(-1)
        self.obj_person.fill_(-1)
        self.it.zero_()
        self.eps.copy_(eps)
        while True:
            cap = int(self.bidders()[1].sum())
            if cap == 0:
                return self.person_obj.clone()
            self.run(cap)


def auction_lsa(cost_matrix: torch.Tensor, *, n_phases: int = 14,
                max_iters_per_phase: int = 4000, rel_tol: float = 1e-6) -> torch.Tensor:
    """Linear assignment on the tensor's device by the eps-scaling auction:
    ``cost_matrix [..., N, N]`` -> ``cols [..., N]`` (int64), row ``i``
    matched to column ``cols[..., i]`` at the least total cost.

    Each pair's eps falls geometrically over ``n_phases`` phases from a
    quarter of its cost range to ``max(rel_tol, 2e-6)`` of it (the floor
    keeps eps above fp32's price resolution); the prices carry over from
    phase to phase, the assignment starts afresh in each. The total is
    within N eps_final of the optimum (Bertsekas' eps-complementary
    slackness); a row the last phase left unassigned (at the iteration cap)
    takes the first free column, so the result is always a permutation."""
    n = cost_matrix.shape[-1]
    lead = cost_matrix.shape[:-2]
    benefit = -cost_matrix.detach().float().reshape(-1, n, n)
    flat = benefit.reshape(benefit.shape[0], -1)
    span = (flat.amax(1) - flat.amin(1)).clamp_min(1e-30)
    eps_start = span / 4.0
    eps_final = span * max(rel_tol, 2e-6)
    ratio = (eps_final / eps_start) ** (1.0 / max(n_phases - 1, 1))
    auction = _Auction(benefit, max_iters_per_phase)
    for q in range(n_phases):
        cols = auction.phase(eps_start * ratio ** q)
    # unmatched rows take the free columns in order
    iota = torch.arange(n, device=benefit.device)
    taken = torch.zeros((benefit.shape[0], n + 1), dtype=torch.bool, device=benefit.device)
    taken.scatter_(1, torch.where(cols >= 0, cols, n), True)
    free_cols = torch.argsort(torch.where(taken[:, :n], n, iota), dim=1, stable=True)
    unmatched_rank = (torch.cumsum((cols < 0).long(), 1) - 1).clamp(0, n - 1)
    cols = torch.where(cols >= 0, cols, free_cols.gather(1, unmatched_rank))
    return cols.reshape(*lead, n)


def auction_emd(p1: torch.Tensor, p2: torch.Tensor, match: str = "l1", average: str = "l1",
                **auction_kw) -> torch.Tensor:
    """Exact EMD as ``scipy_emd``, the assignment by ``auction_lsa`` on the
    tensors' device: ``[..., N, D]`` sets of equal N -> [...]."""
    match_dist = distance_matrix(p1, p2, squared=_squared(match))
    cols = auction_lsa(match_dist, **auction_kw)
    return _matched_mean(p1, p2, match_dist, cols, match, average)


def sinkhorn_emd(p1: torch.Tensor, p2: torch.Tensor, epsilon: float = 0.01,
                 n_iters: int = 100) -> torch.Tensor:
    """Entropy-regularised EMD ``<P, C>`` by ``n_iters`` log-domain
    Sinkhorn iterations, uniform marginals: ``[..., N, D] x [..., M, D] ->
    [...]``."""
    cost = distance_matrix(p1, p2, squared=False).float()
    n, m = cost.shape[-2], cost.shape[-1]
    log_mu = torch.full(cost.shape[:-1], -math.log(n), device=cost.device)
    log_nu = torch.full((*cost.shape[:-2], m), -math.log(m), device=cost.device)
    neg_c = -cost / epsilon
    f, g = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(n_iters):
        # f_i = eps (log mu_i - logsumexp_j((g_j - C_ij) / eps)), then g
        f = epsilon * (log_mu - torch.logsumexp(neg_c + g[..., None, :] / epsilon, dim=-1))
        g = epsilon * (log_nu - torch.logsumexp(neg_c + f[..., :, None] / epsilon, dim=-2))
    log_p = neg_c + (f[..., :, None] + g[..., None, :]) / epsilon
    return (torch.exp(log_p) * cost).sum(dim=(-2, -1))


class Metric:
    """Protocol: ``__call__(model, points, raw_ctx, generator) -> dict`` of
    per-batch tensors."""

    name: str

    def __call__(self, model, points, raw_ctx, generator) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class LossMetric(Metric):
    """The validation loss: ``Diffusion.loss`` at sigma and noise drawn
    from the generator, without a gradient."""

    def __init__(self, loss_scale: float = 1.0):
        self.loss_scale = loss_scale
        self.name = "loss"

    def __call__(self, model, points, raw_ctx, generator) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return {"loss": model.loss(points, generator, raw_ctx, loss_scale=self.loss_scale)}


class LogpMetric(Metric):
    """The exact likelihood's decomposition (``Diffusion.evaluate_logp``)
    per example: ``"total"`` = ``"prior"`` + ``"det-jac"`` (the integrated
    divergence) + ``"reparam"``. ``n_solver_steps`` overrides the
    schedule's grid for the reverse ODE (the configs take 24): the absolute
    value moves with it, so compare runs only at equal settings."""

    def __init__(self, n_log_det_jac_samples: int = 1, n_solver_steps: Optional[int] = None):
        self.name = "logp"
        self.n_log_det_jac_samples = n_log_det_jac_samples
        self.n_solver_steps = n_solver_steps

    def __call__(self, model, points, raw_ctx, generator) -> Dict[str, torch.Tensor]:
        details = model.evaluate_logp(generator, points, raw_ctx=raw_ctx,
                                      n_log_det_jac_samples=self.n_log_det_jac_samples,
                                      n_solver_steps=self.n_solver_steps, return_details=True)
        return {"total": details.logp, "prior": details.prior_logp,
                "det-jac": details.delta_jacobian, "reparam": details.delta_reparam}


class SupervisedMetric(Metric):
    """Sample conditionally (``Diffusion.sample``) and compare with the
    ground truth, each distance under its function's name."""

    def __init__(self, metrics: Sequence[Callable] = (chamfer_distance,)):
        self.name = "supervised"
        self.metrics = tuple(metrics)

    def __call__(self, model, points, raw_ctx, generator) -> Dict[str, torch.Tensor]:
        samples = model.sample(generator, tuple(points.shape), raw_ctx=raw_ctx)
        return {getattr(m, "__name__", str(m)): m(samples, points) for m in self.metrics}
