"""Learning-to-rank objectives (reference src/objective/rank_objective.hpp:
``RankingObjective`` base parallelizing per query at :25-67, LambdarankNDCG
pairwise lambdas at :140-227, RankXENDCG at :284-352).  Port of
``lightgbm_tpu/objective/rank.py``.

Queries are padded to a common length M (``pad_queries``, copied) and each
chunk of queries is one batched (Q, M, M) tensor expression, so the
pairwise memory stays bounded.  The reference jits these gradients, and
XLA fuses and reorders their f32 sums, so the port agrees with it within
f32 rounding, not bitwise (ROADMAP watch list).  ``rank_xendcg`` draws its
gammas from the port's threefry stream (utils/random.py) under
``fold_in(PRNGKey(objective_seed), iteration)``, the reference's key, so
both packages draw the same gammas."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.random import fold_in, host_key, uniform
from .base import EPS, ObjectiveFunction

KMIN_SCORE = -1e30


def pad_queries(query_boundaries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Build (Q, M) flat-index + validity arrays from query boundaries
    (copy of the reference's)."""
    sizes = np.diff(query_boundaries)
    q = len(sizes)
    m = int(sizes.max()) if q else 1
    # round M up to a lane-friendly multiple
    m = int(np.ceil(m / 8) * 8)
    idx = np.zeros((q, m), dtype=np.int32)
    valid = np.zeros((q, m), dtype=bool)
    for i in range(q):
        s, e = query_boundaries[i], query_boundaries[i + 1]
        idx[i, : e - s] = np.arange(s, e)
        valid[i, : e - s] = True
    return idx, valid


def _scatter_rows(n: int, q_idx: torch.Tensor, vals: torch.Tensor
                  ) -> torch.Tensor:
    """(n,) sums of the (Q, M) per-document values at their rows (padding
    slots carry zeros)."""
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, q_idx.reshape(-1), vals.reshape(-1).float())


class RankingObjective(ObjectiveFunction):
    need_group = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            raise ValueError(f"objective {self.name} requires query/group data")
        self.query_boundaries = metadata.query_boundaries
        idx, valid = pad_queries(self.query_boundaries)
        self.q_idx = torch.as_tensor(idx.astype(np.int64), device=self.device)
        self.q_valid = torch.as_tensor(valid, device=self.device)
        self.num_queries = idx.shape[0]
        # chunk queries so the (chunk, M, M) pairwise tensor stays ~64MB
        m = idx.shape[1]
        self.q_chunk = max(1, min(self.num_queries,
                                  int((16 << 20) / max(1, m * m))))


class LambdarankNDCG(RankingObjective):
    name = "lambdarank"

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.sigmoid = float(config.sigmoid)
        self.norm = bool(config.lambdarank_norm)
        self.truncation_level = int(config.lambdarank_truncation_level)
        self.label_gain = np.asarray(config.label_gain, dtype=np.float64)

    def check_label(self, label):
        if (label < 0).any():
            raise ValueError("ranking labels must be non-negative integers")
        if int(label.max()) >= len(self.label_gain):
            raise ValueError("label exceeds label_gain size")

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        # inverse max DCG per query at the truncation level
        # (rank_objective.hpp:121-135 via dcg_calculator.cpp CalMaxDCGAtK)
        lab = np.asarray(metadata.label)
        qb = self.query_boundaries
        inv = np.zeros(self.num_queries)
        for i in range(self.num_queries):
            ql = np.sort(lab[qb[i]:qb[i + 1]])[::-1][:self.truncation_level]
            gains = self.label_gain[ql.astype(np.int32)]
            disc = 1.0 / np.log2(np.arange(len(ql)) + 2.0)
            mdcg = float((gains * disc).sum())
            inv[i] = 1.0 / mdcg if mdcg > 0 else 0.0
        self.inverse_max_dcg = torch.as_tensor(inv.astype(np.float32),
                                               device=self.device)
        self.label_gain_dev = torch.as_tensor(
            self.label_gain.astype(np.float32), device=self.device)

    def _chunk(self, s, lab, valid, inv_max_dcg):
        """(lambdas, hessians) of a (Q, M) chunk of queries, in
        query-document order (the reference's vmapped ``one_query``)."""
        q, m = s.shape
        dev = s.device
        sig = self.sigmoid
        s_in = torch.where(valid, s, torch.full_like(s, KMIN_SCORE))
        # sort docs by score desc (stable); padding scores are KMIN_SCORE
        order = torch.sort(-s_in, dim=1, stable=True).indices
        ss = torch.gather(s_in, 1, order)
        sl = torch.gather(lab, 1, order)
        sv = torch.gather(valid, 1, order)
        gains = self.label_gain_dev[torch.clamp(sl.to(torch.int64), min=0)]
        ranks = torch.arange(m, device=dev)
        disc = 1.0 / torch.log2(ranks.float() + 2.0)
        n_valid = sv.sum(dim=1)
        best = ss[:, 0]
        worst = torch.gather(ss, 1, torch.clamp(n_valid - 1, min=0)
                             .unsqueeze(1))[:, 0]

        iu = ranks[:, None]
        ju = ranks[None, :]
        pair = ((iu < ju) & sv[:, :, None] & sv[:, None, :] &
                (sl[:, :, None] != sl[:, None, :]) &
                (iu < self.truncation_level))
        hi_is_i = sl[:, :, None] > sl[:, None, :]
        s_hi = torch.where(hi_is_i, ss[:, :, None], ss[:, None, :])
        s_lo = torch.where(hi_is_i, ss[:, None, :], ss[:, :, None])
        delta_score = s_hi - s_lo
        dcg_gap = torch.abs(gains[:, :, None] - gains[:, None, :])
        paired_disc = torch.abs(disc[:, None] - disc[None, :])
        delta_ndcg = dcg_gap * paired_disc * inv_max_dcg[:, None, None]
        if self.norm:
            delta_ndcg = torch.where(
                (best != worst)[:, None, None],
                delta_ndcg / (0.01 + torch.abs(delta_score)), delta_ndcg)
        p = 1.0 / (1.0 + torch.exp(sig * delta_score))
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        p_lambda = torch.where(pair, -sig * delta_ndcg * p, zero)
        p_hess = torch.where(pair, sig * sig * delta_ndcg * p * (1.0 - p),
                             zero)

        contrib = torch.where(hi_is_i, p_lambda, -p_lambda)
        lam_sorted = contrib.sum(dim=2) - contrib.sum(dim=1)
        hess_sorted = p_hess.sum(dim=2) + p_hess.sum(dim=1)
        if self.norm:
            sum_lambdas = -2.0 * p_lambda.sum(dim=(1, 2))
            factor = torch.where(
                sum_lambdas > 0,
                torch.log2(1.0 + sum_lambdas) /
                torch.clamp(sum_lambdas, min=EPS),
                torch.ones_like(sum_lambdas))
            lam_sorted = lam_sorted * factor[:, None]
            hess_sorted = hess_sorted * factor[:, None]
        # unsort back to query-document order
        lam = torch.empty_like(lam_sorted).scatter_(1, order, lam_sorted)
        hes = torch.empty_like(hess_sorted).scatter_(1, order, hess_sorted)
        return lam, hes

    def get_gradients(self, score):
        s_g = score[self.q_idx]
        l_g = self.label[self.q_idx]
        lams, hess = [], []
        for c in range(0, self.num_queries, self.q_chunk):
            sl_ = slice(c, c + self.q_chunk)
            lam, hes = self._chunk(s_g[sl_], l_g[sl_], self.q_valid[sl_],
                                   self.inverse_max_dcg[sl_])
            lams.append(lam)
            hess.append(hes)
        zero = torch.zeros((), dtype=torch.float32, device=score.device)
        v = self.q_valid
        n = score.shape[0]
        return (_scatter_rows(n, self.q_idx, torch.where(v, torch.cat(lams),
                                                         zero)),
                _scatter_rows(n, self.q_idx, torch.where(v, torch.cat(hess),
                                                         zero)))


class RankXENDCG(RankingObjective):
    name = "rank_xendcg"

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.seed = int(config.objective_seed)
        self._iter = 0

    def check_label(self, label):
        if (label < 0).any():
            raise ValueError("ranking labels must be non-negative integers")

    def get_gradients(self, score):
        key = fold_in(host_key(self.seed), self._iter)
        self._iter += 1
        n = score.shape[0]
        q_idx, q_valid = self.q_idx, self.q_valid
        zero = torch.zeros((), dtype=torch.float32, device=score.device)
        s = torch.where(q_valid, score[q_idx],
                        torch.full((), KMIN_SCORE, dtype=torch.float32,
                                   device=score.device))
        lab = self.label[q_idx]
        gammas = uniform(key, tuple(q_idx.shape), score.device)

        # per-query softmax over valid docs
        smax = torch.amax(s, dim=1, keepdim=True)
        es = torch.where(q_valid, torch.exp(s - smax), zero)
        rho = es / torch.clamp(es.sum(dim=1, keepdim=True), min=EPS)

        phi = torch.where(q_valid, torch.exp2(torch.floor(lab)) - gammas,
                          zero)
        inv_den = 1.0 / torch.clamp(phi.sum(dim=1, keepdim=True), min=EPS)

        # first-order terms (rank_objective.hpp:330-338)
        t1 = -phi * inv_den + rho
        params1 = torch.where(q_valid, t1 / torch.clamp(1.0 - rho, min=EPS),
                              zero)
        sum_l1 = params1.sum(dim=1, keepdim=True)
        # second-order
        t2 = rho * (sum_l1 - params1)
        params2 = torch.where(q_valid, t2 / torch.clamp(1.0 - rho, min=EPS),
                              zero)
        sum_l2 = params2.sum(dim=1, keepdim=True)
        lam = t1 + t2 + rho * (sum_l2 - params2)
        hess = rho * (1.0 - rho)
        # queries with <2 docs get zero gradients
        drop = (q_valid.sum(dim=1, keepdim=True) <= 1) | ~q_valid
        lam = torch.where(drop, zero, lam)
        hess = torch.where(drop, zero, hess)
        return (_scatter_rows(n, q_idx, lam), _scatter_rows(n, q_idx, hess))
