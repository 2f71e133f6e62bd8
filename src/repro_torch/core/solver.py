"""Exact (microbatch k, action) assignment solver — the optimal-plan
tier, copied from the reference's ``core/solver.py``.

The density greedy in ``core/scheduler.py`` approximates the joint
(k, KEEP/REMAT/OFFLOAD) assignment; this module solves it exactly
without giving up Mimose's online property: greedy still serves the
first steps of a new bucket at once, while ``BackgroundSolver`` (a
daemon thread with a bounded work queue, one in-flight solve per
plan-cache key) runs ``solve()`` and swaps a strictly better plan into
the planner's LRU cache — the trainer picks it up on the next cache hit
and builds a step function for that bucket's new plan only.

``solve()`` is exact because the liveness simulator's peak decomposes
per unit.  With ``c_j`` the forward contribution of unit j under its
action (KEEP ``act``, REMAT ``out``, OFFLOAD ``act - off``) and
``restore_j`` the backward restore (0 / ``act`` / ``off``):

* forward transient at i:  ``fixed + sum_{j<i} c_j + act_i + out_i``
* end of forward:          ``fixed + sum_j c_j``
* backward at i:           ``fixed + sum_{j<=i} c_j
  + sum_{j>i, REMAT} out_j + restore_i + act_i``

So a left-to-right DP over the chain needs only the state ``(v, m)`` —
``v`` the accumulated forward contribution, ``m`` the tightest
remaining allowance for remat-out bytes of still-undecided units — plus
the plan's separable cost (from the same ``ActionTables`` the greedy
scores with).  Pareto dominance prunes the states; an optional byte
grid quantises ``v`` up / ``m`` down (conservative: an accepted plan is
always truly feasible) when the frontier grows past ``max_states``.
Small instances brute-force all ``3^n`` rows through ``simulate_many``.

Every candidate — DP optimum per k, exhaustive optimum, the greedy plan,
seed plans — is replayed through the scalar ``simulate`` before
comparison, so ``solve() <= greedy()`` holds by construction.

A background solve is traced as a ``solve`` span on the solver track
of the planner's telemetry, and a swap as a ``solver_swap`` instant
(plus a ``solver_swap`` event when the event log is on).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import queue
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.actions import Action
from repro_torch.core.scheduler import (ActionTables, Plan, action_tables,
                                        greedy_plan_adaptive)
from repro_torch.core.simulator import link_rate, simulate, simulate_many
from repro_torch.launch.roofline import MICROBATCH_OVERHEAD_S
from repro_torch.obs import TRACK_SOLVER

# feasibility tolerance — MUST match the scheduler's replay convention
# (`peak_bytes <= budget + 1e-6`) or the tiers would disagree at the
# boundary
_FEAS_TOL = 1e-6
_INF = float("inf")


class SolveTimeout(Exception):
    """Internal: the solve deadline expired mid-DP."""


# states below this count get the exact O(S log S) Pareto sweep (pure
# python, so only worth it while the frontier is small); above it the
# grid quantisation in _dp_actions is the sole growth control
_PARETO_CUTOFF = 4096


def _skyline_keep(v: np.ndarray, m: np.ndarray,
                  cost: np.ndarray) -> np.ndarray:
    """Exact Pareto mask over DP states: state A dominates B iff
    ``v_A <= v_B``, ``m_A >= m_B`` and ``cost_A <= cost_B``.  Sweeps in
    ascending ``v`` keeping an (m, cost) skyline."""
    order = np.lexsort((cost, -m, v))      # v asc, m desc, cost asc
    keep = np.zeros(v.size, dtype=bool)
    front_m: list = []                     # ascending m ...
    front_c: list = []                     # ... with strictly asc cost
    for idx in order:
        mm, cc = m[idx], cost[idx]
        lo = bisect.bisect_left(front_m, mm)
        if lo < len(front_m) and front_c[lo] <= cc:
            continue                       # dominated by a prior state
        hi = bisect.bisect_right(front_m, mm)
        j = hi
        while j > 0 and front_c[j - 1] >= cc:
            j -= 1
        del front_m[j:hi]
        del front_c[j:hi]
        front_m.insert(j, mm)
        front_c.insert(j, cc)
        keep[idx] = True
    return keep


def _dedup(v, m, cost, par, act):
    """Keep the min-cost state per exact ``(v, m)`` key (numpy)."""
    order = np.lexsort((cost, m, v))
    v, m = v[order], m[order]
    first = np.ones(v.size, dtype=bool)
    first[1:] = (v[1:] != v[:-1]) | (m[1:] != m[:-1])
    sel = order[first]
    return v[first], m[first], cost[sel], par[sel], act[sel]


def _dp_actions(tabs: ActionTables, headroom: float, *,
                deadline: Optional[float] = None,
                grid_bytes: float = 0.0,
                max_states: int = 30_000
                ) -> Optional[Tuple[Tuple[int, ...], float]]:
    """DP over one chain at fixed k.  ``headroom`` is
    ``budget - fixed``.  Returns ``(action codes, per-microbatch cost
    seconds)`` for the cheapest feasible plan found, or ``None`` when
    no assignment fits.  Exact while the state frontier stays under
    ``max_states`` (always the case for ``n <= 8``: at most ``3^n``
    states exist); past that the byte grid escalates with conservative
    rounding — ``v`` up, ``m`` down — so any plan returned is still
    truly feasible, it may just not be the global optimum.  Raises
    ``SolveTimeout`` past ``deadline`` (``time.monotonic`` seconds)."""
    est, out, off = tabs.est, tabs.out, tabs.off
    t_re, t_off = tabs.t_re, tabs.t_off
    n = est.size
    opt = tabs.opt if tabs.opt is not None else np.zeros(n)
    t_opt = tabs.t_opt if tabs.t_opt is not None else np.zeros(n)
    B = float(headroom) + _FEAS_TOL
    g = float(grid_bytes)
    v = np.zeros(1)
    m = np.full(1, _INF)
    cost = np.zeros(1)
    trail: list = []              # per unit: (parent index, action code)

    for i in range(n):
        if deadline is not None and time.monotonic() > deadline:
            raise SolveTimeout
        a_i, o_i, f_i = float(est[i]), float(out[i]), float(off[i])
        p_i = float(opt[i])
        ok_fwd = v + (a_i + o_i) <= B      # forward transient of unit i
        # (contribution, restore, remat-out, unit cost) per action code
        trans = [(a_i, 0.0, 0.0, 0.0),                      # KEEP
                 (o_i, a_i, o_i, float(t_re[i])),           # REMAT
                 (a_i - f_i, f_i, 0.0, float(t_off[i]))]    # OFFLOAD
        if p_i > 0:
            # OFFLOAD_OPT: KEEP liveness, but the parked moment bytes
            # raise the headroom.  Folding the credit into the forward
            # contribution grants it to positions >= i only (prefix-only
            # credit — conservative: the DP can over-, never
            # under-estimate a peak, and the winner is re-scored by the
            # exact scalar simulate).  ``t_opt`` is per STEP while
            # t_re/t_off are per microbatch, a ranking skew at k > 1
            # the exact replay also corrects.
            trans.append((a_i - p_i, 0.0, 0.0, float(t_opt[i])))
        cat: list = []
        for code, (cc, rr, qq, ww) in enumerate(trans):
            v2 = v + cc
            # backward peak at i caps the remat-out bytes of every
            # LATER unit; fold it into the running minimum m
            m2 = np.minimum(m - qq, B - v2 - rr - a_i)
            idx = np.nonzero(ok_fwd & (v2 <= B) & (m2 >= 0))[0]
            if idx.size:
                cat.append((v2[idx], m2[idx], cost[idx] + ww, idx,
                            np.full(idx.size, code, dtype=np.int8)))
        if not cat:
            return None                    # no feasible assignment
        v = np.concatenate([c[0] for c in cat])
        m = np.concatenate([c[1] for c in cat])
        cost = np.concatenate([c[2] for c in cat])
        par = np.concatenate([c[3] for c in cat])
        act = np.concatenate([c[4] for c in cat])
        if g > 0:                          # conservative: v up, m down
            v = np.ceil(v / g) * g
            m = np.floor(m / g) * g        # floor(inf) stays inf
            ok = (v <= B) & (m >= 0)
            v, m, cost, par, act = v[ok], m[ok], cost[ok], par[ok], act[ok]
            if not v.size:
                return None
        v, m, cost, par, act = _dedup(v, m, cost, par, act)
        if v.size <= _PARETO_CUTOFF:
            keep = _skyline_keep(v, m, cost)
            v, m, cost, par, act = (v[keep], m[keep], cost[keep],
                                    par[keep], act[keep])
        # frontier too wide: escalate the grid — conservative rounding
        # keeps every surviving plan feasible
        while v.size > max_states:
            g = g * 2.0 if g > 0 else max(B / 4096.0, 1.0)
            vq = np.ceil(v / g) * g
            mq = np.floor(m / g) * g
            ok = (vq <= B) & (mq >= 0)
            if not ok.any():
                return None
            v, m, cost, par, act = _dedup(vq[ok], mq[ok], cost[ok],
                                          par[ok], act[ok])
            if g > 16.0 * max(B, 1.0):
                break
        trail.append((par, act))
    best = int(np.argmin(cost))
    codes: list = []
    idx = best
    for par, act in reversed(trail):
        codes.append(int(act[idx]))
        idx = int(par[idx])
    codes.reverse()
    return tuple(codes), float(cost[best])


def enumerate_plans(n: int, base: int = 3) -> np.ndarray:
    """All ``base^n`` action-code rows, lexicographic — the shared
    enumeration of the exhaustive fallback and ``tests/oracle.py``.
    ``base=3`` covers KEEP/REMAT/OFFLOAD (n <= 12); ``base=4`` adds
    OFFLOAD_OPT (n <= 8: 4^8 = 65536 rows)."""
    if n == 0:
        return np.zeros((1, 0), dtype=np.int64)
    limit = 12 if base <= 3 else 8
    if n > limit:
        raise ValueError(f"{base}^{n} plans is too many to enumerate")
    codes = np.arange(base ** n, dtype=np.int64)
    place = base ** np.arange(n - 1, -1, -1, dtype=np.int64)
    return (codes[:, None] // place) % base


def _exhaustive_actions(tabs: ActionTables, budget: float, fixed: float,
                        k: int, pcie: float, overlap: float,
                        accum: float) -> Tuple[int, ...]:
    """Brute force all plans through ``simulate_many``; returns the
    feasible row with the lowest (overhead, n_host_actions, index), or
    the min-peak row when nothing fits.  Enumerates base 4 (OFFLOAD_OPT
    included) only when the opt vector has positive entries and the
    chain is short enough (n <= 8); otherwise base 3, bit-identical to
    the pre-opt solver."""
    n = tabs.est.size
    has_opt = tabs.opt is not None and bool(np.any(tabs.opt > 0))
    base = 4 if has_opt and n <= 8 else 3
    A = enumerate_plans(n, base=base)
    bs = simulate_many(tabs.est, A, fixed, tabs.out, tabs.fl,
                       offload_bytes=tabs.off, opt_bytes=tabs.opt,
                       pcie_bytes_per_s=pcie,
                       overlap=overlap, microbatch=k,
                       accum_overhead_s=accum)
    feas = np.nonzero(bs.peak_bytes <= budget + _FEAS_TOL)[0]
    if feas.size:
        # ties prefer fewer host-involved units (OFFLOAD + OFFLOAD_OPT;
        # identical to the old (A == 2) count for base-3 enumerations)
        n_off = (A[feas] >= 2).sum(axis=1)
        order = np.lexsort((feas, n_off, bs.step_overhead_s[feas]))
        best = int(feas[order[0]])
    else:
        best = int(np.argmin(bs.peak_bytes))
    return tuple(int(c) for c in A[best])


@dataclasses.dataclass
class SolveResult:
    """Outcome of one ``solve()`` call.  ``score`` is the plan's
    simulated step overhead plus its pad overhead — the exact quantity
    ``tests/oracle.py`` minimises."""
    plan: Optional[Plan]
    feasible: bool
    score: float
    overhead_s: float
    peak_bytes: float
    method: str                   # origin of the winner
    timed_out: bool = False
    solve_s: float = 0.0


def solve(vectors_of_k, budget_bytes: float, fixed_bytes: float = 0.0, *,
          candidate_ks: Sequence[int] = (1,), tol: float = 0.10,
          pcie_bytes_per_s: float | None = None,
          offload_overlap: float = 0.5,
          accum_overhead_s: float | None = None,
          method: str = "auto", deadline_s: Optional[float] = None,
          grid_bytes: float = 0.0, max_states: int = 30_000,
          exhaustive_max_units: int = 8,
          include_greedy: bool = True,
          seed_plans: Sequence[Plan] = ()) -> SolveResult:
    """Optimal (k, action) assignment under ``budget_bytes``.

    Same contract as ``scheduler.greedy_plan_adaptive``:
    ``vectors_of_k(k)`` returns the per-microbatch planning vectors at
    split ``k`` (``est_mem`` required; ``flops`` / ``output_bytes`` /
    ``offload_bytes`` / ``pad_overhead_s`` optional).  ``method``:

    * ``"dp"``         — the exact chain DP per candidate k;
    * ``"exhaustive"`` — brute-force ``3^n`` rows per k (n <= 12);
    * ``"auto"``       — exhaustive when ``n <= exhaustive_max_units``,
      DP otherwise.

    With ``include_greedy`` (default) the greedy plan competes as a
    candidate, so the result is never worse than greedy at equal budget
    — including on timeout, when the best candidate found so far is
    returned with ``timed_out=True``.  The winner among feasible
    candidates minimises ``(score, k, n_offload)``; when nothing fits
    the min-peak candidate wins (and ``feasible`` is False).  A ``None``
    link rate or accumulation overhead means the roofline constant.
    """
    pcie_bytes_per_s = link_rate(pcie_bytes_per_s)
    if accum_overhead_s is None:
        accum_overhead_s = MICROBATCH_OVERHEAD_S
    t0 = time.monotonic()
    deadline = t0 + float(deadline_s) if deadline_s else None
    ks = sorted(set(int(k) for k in candidate_ks))
    assert ks and ks[0] >= 1, ks
    budget = float(budget_bytes)
    fixed = float(fixed_bytes)
    cands: list = []              # (plan, sim, pad, origin)

    def evaluate(plan: Plan, origin: str) -> None:
        k = max(int(plan.microbatch), 1)
        v = vectors_of_k(k)
        if len(plan.actions) != np.asarray(v["est_mem"]).size:
            return                # stale seed from another geometry
        sim = simulate(v["est_mem"], plan.actions, fixed,
                       v.get("output_bytes"), v.get("flops"),
                       offload_bytes=v.get("offload_bytes"),
                       opt_bytes=v.get("opt_bytes"),
                       pcie_bytes_per_s=pcie_bytes_per_s,
                       overlap=offload_overlap, microbatch=k,
                       accum_overhead_s=accum_overhead_s)
        plan.recompute_flops = sim.recompute_flops
        plan.offload_bytes = sim.offload_bytes
        plan.opt_offload_bytes = sim.opt_offload_bytes
        cands.append((plan, sim, float(v.get("pad_overhead_s", 0.0)),
                      origin))

    if include_greedy:
        greedy = greedy_plan_adaptive(
            vectors_of_k, budget, fixed, candidate_ks=ks, tol=tol,
            pcie_bytes_per_s=pcie_bytes_per_s,
            offload_overlap=offload_overlap,
            accum_overhead_s=accum_overhead_s)
        evaluate(greedy, "greedy")
    for seed in seed_plans:
        try:
            evaluate(dataclasses.replace(seed), "seed")
        except Exception:
            continue              # a seed must never break the solve

    timed_out = False
    for k in ks:
        if deadline is not None and time.monotonic() > deadline:
            timed_out = True
            break
        v = vectors_of_k(k)
        tabs = action_tables(v["est_mem"], v.get("output_bytes"),
                             v.get("offload_bytes"), v.get("flops"),
                             opt_bytes=v.get("opt_bytes"),
                             pcie_bytes_per_s=pcie_bytes_per_s,
                             offload_overlap=offload_overlap)
        n = tabs.est.size
        use = method
        if use == "auto":
            use = "exhaustive" if n <= exhaustive_max_units else "dp"
        try:
            if use == "exhaustive":
                codes = _exhaustive_actions(
                    tabs, budget, fixed, k, pcie_bytes_per_s,
                    offload_overlap, accum_overhead_s)
            else:
                hit = _dp_actions(tabs, budget - fixed, deadline=deadline,
                                  grid_bytes=grid_bytes,
                                  max_states=max_states)
                if hit is None:
                    continue      # DP proved k infeasible
                codes = hit[0]
        except SolveTimeout:
            timed_out = True
            break
        total = float(tabs.est.sum())
        arr = np.asarray(codes, dtype=np.int64)
        covered = float(tabs.freed_re[arr == 1].sum()
                        + tabs.freed_off[arr == 2].sum()
                        + tabs.freed_opt[arr == 3].sum())
        plan = Plan([], total + fixed - budget, covered, total,
                    actions=tuple(Action(int(c)) for c in codes))
        plan.microbatch = k
        evaluate(plan, use)

    if not cands:
        return SolveResult(None, False, _INF, _INF, _INF, "none",
                           timed_out=timed_out,
                           solve_s=time.monotonic() - t0)
    fits = [s.peak_bytes <= budget + _FEAS_TOL for _, s, _, _ in cands]
    if any(fits):
        best = min((i for i in range(len(cands)) if fits[i]),
                   key=lambda i: (cands[i][1].step_overhead_s
                                  + cands[i][2],
                                  cands[i][0].microbatch,
                                  cands[i][0].n_offload))
        feasible = True
    else:
        best = min(range(len(cands)), key=lambda i: cands[i][1].peak_bytes)
        feasible = False
    plan, sim, pad, origin = cands[best]
    return SolveResult(plan, feasible, sim.step_overhead_s + pad,
                       sim.step_overhead_s, sim.peak_bytes, origin,
                       timed_out=timed_out,
                       solve_s=time.monotonic() - t0)


@dataclasses.dataclass
class SolveRequest:
    """One queued background solve.  The planning vectors are
    materialised on the MAIN thread at submit time (estimator predicts,
    flops geometry) so the daemon thread is pure numpy — no collection
    off the training thread."""
    key: tuple                    # plan-cache key the result may replace
    bucket: int                   # bucket id, for per-bucket stats
    vectors: Dict[int, dict]      # k -> vectors_of_k(k) snapshot
    budget_bytes: float
    fixed_bytes: float
    candidate_ks: Tuple[int, ...]
    pcie_bytes_per_s: float
    offload_overlap: float
    accum_overhead_s: float
    baseline: Plan                # the cached greedy plan to beat


class BackgroundSolver:
    """Daemon-thread solver tier around a planner's LRU plan cache.

    Swap-in protocol: a solved plan replaces the cache entry only under
    the planner's ``_cache_lock`` AND only while the entry is still the
    *same object* the solve started from — the drift-audit refit
    (``cache.clear()``) installs new objects, so a stale solve is
    dropped without any epoch bookkeeping.  Swaps happen only on STRICT
    score improvement: a tie keeps the greedy plan and avoids building
    a new step function for nothing.
    """

    def __init__(self, planner, *, budget_ms: float = 50.0,
                 method: str = "auto", max_queue: int = 8,
                 grid_bytes: float = 0.0, max_states: int = 30_000):
        self.planner = planner
        self.budget_ms = float(budget_ms)
        self.method = method
        self.grid_bytes = float(grid_bytes)
        self.max_states = int(max_states)
        self.dropped = 0          # submissions rejected (queue full)
        self.errors = 0           # solves that raised (never propagate)
        self._queue: "queue.Queue[SolveRequest]" = queue.Queue(
            maxsize=max(int(max_queue), 1))
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight: set = set()
        self._pending = 0
        self._thread: Optional[threading.Thread] = None

    def pending(self, key: tuple) -> bool:
        """Is a solve for this plan key queued or running?"""
        with self._lock:
            return key in self._inflight

    def submit(self, req: SolveRequest) -> bool:
        """Enqueue a solve; at most one in flight per key.  Returns
        False (without blocking the training loop) when the key is
        already pending or the bounded queue is full."""
        with self._lock:
            if req.key in self._inflight:
                return False
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                self.dropped += 1
                return False
            self._inflight.add(req.key)
            self._pending += 1
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="mimose-solver", daemon=True)
                self._thread.start()
        return True

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every queued solve finished (tests / shutdown
        reporting); True when the queue went idle in time."""
        with self._idle:
            return self._idle.wait_for(lambda: self._pending == 0,
                                       timeout=timeout)

    def close(self) -> None:
        """Let the queued solves finish, then end the daemon thread (it
        holds the planner, and through it the model).  A later
        ``submit`` starts a new one."""
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None and thread.is_alive():
            self._queue.put(None)
            thread.join()

    # -- daemon side ---------------------------------------------------
    def _run(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:
                return
            try:
                self._process(req)
            except Exception:
                self.errors += 1  # a solver bug must never kill training
            finally:
                with self._idle:
                    self._inflight.discard(req.key)
                    self._pending -= 1
                    self._idle.notify_all()

    def _replay_score(self, req: SolveRequest, plan: Plan) -> float:
        k = max(int(plan.microbatch), 1)
        v = req.vectors[k]
        sim = simulate(v["est_mem"], plan.actions, req.fixed_bytes,
                       v.get("output_bytes"), v.get("flops"),
                       offload_bytes=v.get("offload_bytes"),
                       opt_bytes=v.get("opt_bytes"),
                       pcie_bytes_per_s=req.pcie_bytes_per_s,
                       overlap=req.offload_overlap, microbatch=k,
                       accum_overhead_s=req.accum_overhead_s)
        return sim.step_overhead_s + float(v.get("pad_overhead_s", 0.0))

    def _process(self, req: SolveRequest) -> None:
        stats = self.planner.stats
        tel = getattr(self.planner, "telemetry", None)
        span = (tel.tracer.span("solve", TRACK_SOLVER,
                                args={"bucket": req.bucket}
                                if tel.trace_on else None)
                if tel is not None else contextlib.nullcontext())
        with span:
            res = solve(lambda k: req.vectors[int(k)], req.budget_bytes,
                        req.fixed_bytes, candidate_ks=req.candidate_ks,
                        pcie_bytes_per_s=req.pcie_bytes_per_s,
                        offload_overlap=req.offload_overlap,
                        accum_overhead_s=req.accum_overhead_s,
                        method=self.method,
                        deadline_s=self.budget_ms / 1e3,
                        grid_bytes=self.grid_bytes,
                        max_states=self.max_states,
                        include_greedy=False, seed_plans=(req.baseline,))
        req.baseline.solver_checked = True
        if res.timed_out:
            stats["solver_timeouts"] = stats.get("solver_timeouts", 0) + 1
        else:
            stats["solves"] = stats.get("solves", 0) + 1
        if res.plan is None:
            return
        base_score = self._replay_score(req, req.baseline)
        by = stats.setdefault("solver_delta_by_bucket", {})
        by[req.bucket] = {"greedy_s": base_score, "solved_s": res.score,
                          "improvement_pct":
                              (100.0 * (1.0 - res.score / base_score)
                               if base_score > 0 else 0.0)}
        win = (res.feasible
               and res.score < base_score - max(1e-12, 1e-9 * base_score))
        if not win:
            return
        stats["solver_wins"] = stats.get("solver_wins", 0) + 1
        plan = res.plan
        plan.source = "dp"
        plan.solver_checked = True
        lock = getattr(self.planner, "_cache_lock", None)
        cache = getattr(self.planner, "cache", None)
        if lock is None or cache is None:
            return
        with lock:
            if cache.get(req.key) is req.baseline:
                cache[req.key] = plan
                stats["solver_swaps"] = stats.get("solver_swaps", 0) + 1
                if tel is not None and tel.events_on:
                    tel.events.emit(
                        "solver_swap", bucket=req.bucket,
                        greedy_s=float(base_score),
                        solved_s=float(res.score),
                        improvement_pct=float(
                            100.0 * (1.0 - res.score / base_score)
                            if base_score > 0 else 0.0),
                        k=int(plan.microbatch))
                if tel is not None:
                    tel.tracer.instant("solver_swap", TRACK_SOLVER,
                                       args={"bucket": req.bucket})
