"""MRF view selection: per-chunk keyframe labeling as a jitted ICM solver.

JAX replacement for the vendored mapmap MAP solver + TexMap driver
(ref: Structure/TexMap.cpp:120-255 view_selection — graph :122-137, label
sets :139-155, unaries 1 − q/colmax :157-180, PairwisePotts(pairwise_cost)
with edge weight adjacent_cost, warm start from labelstorage :200-225,
label 0 = undefined with second-newest-keyframe fallback :228-246;
3rd_party/mapmap/ ~17 kLoC).

SURVEY.md §2 #26: the problem is Potts-pairwise with tiny per-node label
sets (the keyframes observing each chunk, ≤ max_labels), over the
6-neighbor chunk grid — a graph that is 2-colorable by the parity of
chunk coordinates. Parallel ICM with checkerboard (red/black) sweeps is
therefore exact coordinate descent, converges in a few sweeps at this
size, and runs as one fixed-point tensor program over
[nodes, max_labels] costs — no tree sampling, no TBB.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class MRFProblem(NamedTuple):
    unary: jnp.ndarray        # [N, L] unary costs (1e9 for absent labels)
    label_kf: jnp.ndarray     # [N, L] int32 keyframe id per label slot (-1 absent)
    neighbors: jnp.ndarray    # [N, 6] int32 node index (N = self-loop padding)
    parity: jnp.ndarray       # [N] int32 0/1 — checkerboard color
    init_label: jnp.ndarray   # [N] int32 initial label slot (warm start)
    n_valid: jnp.ndarray      # [N] bool — node participates


@functools.partial(jax.jit, static_argnames=("sweeps",))
def solve_icm(problem: MRFProblem, potts_weight: float, edge_weight: float,
              sweeps: int = 12) -> jnp.ndarray:
    """Checkerboard ICM fixed point. Returns [N] label slot per node."""
    n, l = problem.unary.shape
    # neighbor padding: index n → a virtual node with label -2 (never equal)
    label_kf_pad = jnp.concatenate(
        [problem.label_kf, jnp.full((1, l), -2, jnp.int32)], axis=0)

    def node_costs(labels):
        """[N, L] total cost of assigning each label slot, given labels."""
        lab_pad = jnp.concatenate([labels, jnp.zeros(1, jnp.int32)])
        nbr_kf = jnp.take_along_axis(
            label_kf_pad[problem.neighbors],                     # [N, 6, L]
            lab_pad[problem.neighbors][..., None], axis=-1)[..., 0]  # [N, 6]
        # Potts: pay when our keyframe id differs from the neighbor's
        diff = problem.label_kf[:, None, :] != nbr_kf[:, :, None]  # [N, 6, L]
        nbr_real = (problem.neighbors < n)[..., None]
        pair = jnp.sum(jnp.where(nbr_real, diff, False).astype(jnp.float32),
                       axis=1) * (potts_weight * edge_weight)
        return problem.unary + pair

    def sweep(i, labels):
        costs = node_costs(labels)
        best = jnp.argmin(costs, axis=-1).astype(jnp.int32)
        color = i % 2
        upd = (problem.parity == color) & problem.n_valid
        return jnp.where(upd, best, labels)

    return jax.lax.fori_loop(0, sweeps * 2, sweep, problem.init_label)


def mrf_energy(problem: MRFProblem, labels: jnp.ndarray,
               potts_weight: float, edge_weight: float) -> jnp.ndarray:
    """Total labeling energy (for tests: ICM must never increase it)."""
    n, l = problem.unary.shape
    u = jnp.take_along_axis(problem.unary, labels[:, None], axis=1)[:, 0]
    u = jnp.where(problem.n_valid, u, 0.0)
    my_kf = jnp.take_along_axis(problem.label_kf, labels[:, None], axis=1)[:, 0]
    kf_pad = jnp.concatenate([my_kf, jnp.asarray([-2], jnp.int32)])
    nbr_kf = kf_pad[problem.neighbors]                           # [N, 6]
    nbr_real = (problem.neighbors < n) & problem.n_valid[:, None]
    # each undirected edge appears twice in the neighbor lists → ×0.5
    pair = jnp.sum((nbr_kf != my_kf[:, None]) & nbr_real) \
        * (potts_weight * edge_weight) * 0.5
    return jnp.sum(u) + pair


class ViewSelector:
    """Host driver: builds MRF problems from the chunk graph + observation
    table and keeps warm-start labels (ref: TexMap labelstorage)."""

    def __init__(self, max_labels: int = 16, potts_weight: float = 1.0,
                 edge_weight: float = 0.5, sweeps: int = 12,
                 bucket_floor: int = 64):
        self.max_labels = max_labels
        self.potts = potts_weight
        self.edge_w = edge_weight
        self.sweeps = sweeps
        self.bucket_floor = bucket_floor
        # slot -> chosen keyframe id, −1 = none yet (persistent warm
        # start, ref: TexMap labelstorage). A dense array: the MRF
        # assembly reads/writes it with vectorized gathers.
        self.labels = np.full(0, -1, np.int32)

    def ensure_capacity(self, n_slots: int) -> None:
        if len(self.labels) < n_slots:
            new = np.full(n_slots, -1, np.int32)
            new[: len(self.labels)] = self.labels
            self.labels = new

    def build_problem_arrays(self, obs_q: np.ndarray, obs_mask: np.ndarray,
                             meshed: np.ndarray, nbr_slots: np.ndarray,
                             chunk_ids: np.ndarray, newest_kf: int):
        """Vectorized host-side MRF assembly from the dense observation
        arrays + adjacency matrix (mesher.chunk_adjacency_arrays).
        Returns (problem, slots [S] np.int64, label_kf [n, L] np).
        Replaces a per-chunk Python loop that burned ~25 ms of GIL per
        cycle at a few thousand chunks."""
        if len(meshed) == 0:
            return None, meshed, None
        self.ensure_capacity(len(chunk_ids) + 1)
        sl = np.asarray(meshed, np.int64)
        n_real = len(sl)
        # pad node count to a bucket so the jitted solver compiles once
        # per size class, not per call. The floor keeps the shape FIXED
        # for whole runs (growing buckets re-enter the compile/cache-load
        # path mid-loop — see TextureConfig)
        n = max(64, self.bucket_floor)
        while n < n_real:
            n *= 2
        l = self.max_labels

        # column-slice the dense observation table to the ACTIVE keyframe
        # range (bucketed): the table is allocated at max_keyframes=512
        # columns but a session has ~newest_kf of them — the argpartition/
        # sort below over [S, 512] burned ~9 ms of GIL-held numpy per
        # cycle on the 2-core host, starving the tracking thread
        kcap = 64
        while kcap < newest_kf + 1:
            kcap *= 2
        kcap = min(kcap, obs_q.shape[1])
        qs, ms = obs_q[sl, :kcap], obs_mask[sl, :kcap]
        q = np.where(ms & (qs > 0), qs, -np.inf)                # [S, K]
        k_total = q.shape[1]
        l_eff = min(l, k_total)
        # top-l labels per chunk by quality (argpartition + sort of l)
        part = np.argpartition(-q, l_eff - 1, axis=1)[:, :l_eff]
        pq = np.take_along_axis(q, part, axis=1)
        order = np.argsort(-pq, axis=1, kind="stable")
        top_kf = np.take_along_axis(part, order, axis=1).astype(np.int32)
        top_q = np.take_along_axis(pq, order, axis=1)           # [S, l_eff]
        has = np.isfinite(top_q)
        valid_row = has[:, 0]

        unary = np.full((n, l), 1e9, np.float32)
        label_kf = np.full((n, l), -1, np.int32)
        qmax = np.where(valid_row, top_q[:, 0], 1.0)
        with np.errstate(invalid="ignore"):
            u = 1.0 - top_q / qmax[:, None]
        unary[:n_real, :l_eff] = np.where(has, u, 1e9).astype(np.float32)
        label_kf[:n_real, :l_eff] = np.where(has, top_kf, -1)

        # chunks with no positive observation: label 0 = previous label
        # or the second-newest keyframe (ref: TexMap.cpp:228-246)
        fallback_kf = max(newest_kf - 1, 0)
        prev = self.labels[sl]                                  # [S]
        rows_nopos = np.nonzero(~valid_row)[0]
        lab0 = np.where(prev >= 0, prev, fallback_kf)
        label_kf[rows_nopos, 0] = lab0[rows_nopos]
        unary[rows_nopos, 0] = 1.0

        # warm start: previous label's slot index if still in the set
        eq = (top_kf == prev[:, None]) & has
        init = np.zeros(n, np.int32)
        init[:n_real] = np.where(eq.any(axis=1), eq.argmax(axis=1), 0)

        parity = np.zeros(n, np.int32)
        parity[:n_real] = chunk_ids[sl].sum(axis=1) & 1
        valid = np.zeros(n, bool)
        valid[:n_real] = valid_row

        # neighbor slot -> node row (n = virtual no-neighbor node)
        row_lookup = np.full(len(chunk_ids) + 1, n, np.int32)
        row_lookup[sl] = np.arange(n_real, dtype=np.int32)
        nbrs = np.full((n, 6), n, np.int32)
        nbr_w = nbr_slots[:, :6]
        nbrs[:n_real, : nbr_w.shape[1]] = np.where(
            nbr_w >= 0, row_lookup[np.clip(nbr_w, 0, len(chunk_ids))], n)

        problem = MRFProblem(
            unary=jnp.asarray(unary), label_kf=jnp.asarray(label_kf),
            neighbors=jnp.asarray(nbrs), parity=jnp.asarray(parity),
            init_label=jnp.asarray(init), n_valid=jnp.asarray(valid))
        return problem, sl, label_kf

    def build_problem(self, observations: dict, adjacency: dict,
                      chunk_ids: np.ndarray, newest_kf: int):
        """Dict-input MRF assembly (tests / sync select path): converts
        to the dense arrays and calls build_problem_arrays."""
        slots = sorted(adjacency.keys())
        if not slots:
            return None, [], None
        cap = len(chunk_ids)
        max_kf = max((max(d) for d in observations.values() if d),
                     default=0) + 1
        obs_q = np.zeros((cap + 1, max_kf), np.float32)
        obs_mask = np.zeros((cap + 1, max_kf), bool)
        for s, d in observations.items():
            for kf, qv in d.items():
                obs_q[int(s), int(kf)] = qv
                obs_mask[int(s), int(kf)] = True
        meshed = np.asarray(slots, np.int64)
        nbr = np.full((len(slots), 6), -1, np.int64)
        for i, s in enumerate(slots):
            a = np.asarray(adjacency[s], np.int64)[:6]
            nbr[i, : len(a)] = a
        return self.build_problem_arrays(obs_q, obs_mask, meshed, nbr,
                                         chunk_ids, newest_kf)

    def adopt_solution(self, slots, label_kf: np.ndarray,
                       sol: np.ndarray, newest_kf: int) -> dict:
        """Convert solved label slots to keyframe ids + persist warm
        start (ref: TexMap labelstorage + label-0 fallback)."""
        fallback_kf = max(newest_kf - 1, 0)
        sl = np.asarray(slots, np.int64)
        if len(sl) == 0:
            return {}
        self.ensure_capacity(int(sl.max()) + 1)
        kf = label_kf[np.arange(len(sl)), np.asarray(sol)[: len(sl)]]
        prev = self.labels[sl]
        kf = np.where(kf >= 0, kf,
                      np.where(prev >= 0, prev, fallback_kf)).astype(np.int32)
        self.labels[sl] = kf
        return {int(s): int(k) for s, k in zip(sl.tolist(), kf.tolist())}

    def select(self, observations: dict, adjacency: dict, chunk_ids: np.ndarray,
               newest_kf: int) -> dict:
        """observations: slot → {kf: quality}; adjacency: slot → np[slots];
        chunk_ids: [capacity, 3] integer chunk coords (for parity).
        Returns slot → keyframe id. Chunks with no positive-quality
        observation fall back to the second-newest keyframe
        (ref: TexMap.cpp:228-246 label-0 handling)."""
        problem, slots, label_kf = self.build_problem(
            observations, adjacency, chunk_ids, newest_kf)
        if problem is None:
            return {}
        sol = np.asarray(solve_icm(problem, self.potts, self.edge_w,
                                   self.sweeps))
        return self.adopt_solution(slots, label_kf, sol, newest_kf)
