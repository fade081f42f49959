"""What a window runs, per traffic kind, and how its answers are judged.

Two kinds, each a general loop that reads its parameters from the
traffic file:

* ``solve`` — a closed loop, one caller: an all-sources solve through
  ``repro_torch.engine.make_engine(engine, LPConfig(...)).run(net)``,
  then the top-k of the ranked pair per source entity
  (``core.ranking.extract_outputs`` and ``topk_exclusive``);
* ``bio_step`` — a closed loop of the ``dhlp-bio`` cell's
  ``step_fn(src, dst, w, Y, F)``, each step on the next seed chunk.

Each kind sets up in its constructor (inputs from the seed, the program's
set-up, one warm call of the window's own shapes) and has ``window`` (the
timed loop, which asks ``done(t0)`` after each call whether the window has
ended: the runner's :class:`~perfbench.harness.world.Until`, one decision
for every rank of the cell), ``end_to_end``, ``counters``, ``describe``
(how the window went on the host, printed, not compared) and ``check``;
``check`` runs after the window, once the program's state is freed, and
returns the numbers that are compared with the cell's limits.
``control=True`` switches on the program's own bfloat16 path (the control
of the comparison); the benchmark's runs never set it.  More kinds come as
files (``perfbench/kinds/<kind>.py``; ``harness/spec.py``).
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import drugnet, graph, trace, world
from perfbench.reference import lp as ref

_UNTRACED = trace.Tracer(False)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(torch.device(device))


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class _Reservoir:
    """One item drawn uniformly from a stream, by a seeded generator."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([seed, 7])
        self.n = 0
        self.item = None

    def offer(self, item) -> None:
        self.n += 1
        if self.rng.random() * self.n < 1.0:
            self.item = item


def _program_network(net: drugnet.Drugnet):
    from repro_torch.core.network import from_numpy

    return from_numpy(net.P, net.R, type_names=net.type_names)


def _lp_config(config: dict, traffic: dict, control: bool):
    from repro_torch.core.solver import LPConfig

    s = config["solver"]
    return LPConfig(
        alg=traffic["alg"],
        seed_mode=traffic["seed_mode"],
        alpha=s["alpha"],
        sigma=s["sigma"],
        max_iter=s["max_iter"],
        max_inner=s["max_inner"],
        autotune=s["autotune"],
        storage_dtype="bf16" if control else s["storage"],
    )


def _rank_gap(ref_scores, exclude, prog_idx: List[np.ndarray], k: int):
    """Per row: the widest gap by which the program's i-th candidate's
    reference score lies below the reference's i-th best, over the
    reference's best score.  A list that is short, repeats, names an
    excluded or unknown entity reads ``inf``."""
    rows, n = ref_scores.shape
    _, val_ref = ref.topk(ref_scores, exclude, k)
    scale = float(val_ref[:, 0].abs().max()) or 1.0
    prog = np.full((rows, k), -1, dtype=np.int64)
    for r, lst in enumerate(prog_idx):
        lst = np.asarray(lst, dtype=np.int64)
        want = int(torch.isfinite(val_ref[r]).sum())
        if lst.size != want or np.unique(lst).size != lst.size or (lst.size and (lst.min() < 0 or lst.max() >= n)):
            return math.inf
        prog[r, : lst.size] = lst
    p = torch.as_tensor(prog, device=ref_scores.device)
    valid = p >= 0
    got = ref_scores.gather(1, p.clamp(min=0))
    if bool((exclude.gather(1, p.clamp(min=0)) & valid).any()):
        return math.inf
    gap = torch.where(valid, val_ref - got, torch.zeros_like(got))
    worst = float(gap.max()) if gap.numel() else 0.0
    return max(worst, 0.0) / scale


# --------------------------------------------------------------------------
# solve: closed-loop all-sources solves, ranked
# --------------------------------------------------------------------------
class SolveLoop:
    def __init__(self, config, traffic, seed, device, control=False):
        from repro_torch.core.ranking import extract_outputs, topk_exclusive
        from repro_torch.engine import make_engine

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.parts = []
        self.net = drugnet.make(config, seed)
        self.hnet = _program_network(self.net)
        self.lp = _lp_config(config, traffic, control)
        self.engine = make_engine(traffic["engine"], self.lp, device=device)
        self.engine.prepare(self.hnet)
        self.pair = tuple(traffic["rank_pair"])
        self.k = traffic["top_k"]
        self.known = self.net.R[self.pair] > 0
        self._extract, self._topk = extract_outputs, topk_exclusive
        self.solve_once()  # the warm call: every shape the window uses

    def solve_once(self, tracer=_UNTRACED):
        t0 = time.perf_counter()
        with tracer.span("solve"):
            res = self.engine.run(self.hnet)
        t1 = time.perf_counter()
        with tracer.span("rank"):
            block = self._extract(res.F, self.hnet).interactions[self.pair]
            top = [self._topk(block[d], self.k, self.known[d]) for d in range(block.shape[0])]
        self.parts.append((t1 - t0, time.perf_counter() - t1))
        return res, top

    def window(self, seconds, tracer, done=None):
        done = done or world.Until(seconds)
        keep = _Reservoir(self.seed)
        self.rounds: List[int] = []
        self.col_rounds: List[np.ndarray] = []
        self.parts = []
        n = 0
        t0 = time.perf_counter()
        while True:
            res, top = self.solve_once(tracer)
            n += 1
            self.rounds.append(int(res.outer_iters))
            self.col_rounds.append(np.asarray(res.per_column_iters))
            keep.offer((res, top))
            last = (res, top)
            if done(t0):
                break
        self.elapsed = time.perf_counter() - t0
        self.solves = n
        self.kept = [keep.item] if keep.item is last else [keep.item, last]
        return {"attempted": n, "failed": 0}

    def describe(self) -> str:
        return _describe("solve", "rank", self.parts)

    def end_to_end(self) -> Dict[str, float]:
        return {self.traffic["metric"]: self.elapsed / self.solves}

    def counters(self) -> dict:
        return {"solve.rounds": self.rounds, "solve.column_rounds": self.col_rounds,
                "solve.n": self.net.num_nodes, "solve.nnz": self.net.operator_nnz(),
                "solve.base_is_f": self.lp.resolved_seed_mode() == "drift"}

    def check(self) -> Dict[str, float]:
        del self.engine
        _free(self.device)
        s = self.config["solver"]
        dev = self.device
        H, M = ref.operator_blocks(self.net.P, self.net.R, dev)
        h = ref.hetero_scale(len(self.net.P))
        n = self.net.num_nodes
        Y = torch.eye(n, dtype=ref.F64, device=dev)
        out = {"f_err": 0.0, "rank_gap": 0.0}
        if self.traffic["alg"] == "dhlp2":
            A = ref.fused_operator(H, M, s["alpha"], h)
            out["halt_err"] = 0.0
        else:
            Fr = ref.dhlp1(H, M, Y, alpha=s["alpha"], h=h, sigma=s["sigma"],
                           max_iter=s["max_iter"], max_inner=s["max_inner"])
        for res, top in self.kept:
            F = torch.as_tensor(res.F, dtype=ref.F64, device=dev)
            if self.traffic["alg"] == "dhlp2":
                counts = torch.as_tensor(np.asarray(res.per_column_iters), device=dev)
                Fr, d_last, d_prev = ref.iterates_at(A, Y, Y, counts, beta2=(1 - s["alpha"]) ** 2,
                                                     drift=self.lp.resolved_seed_mode() == "drift")
                out["halt_err"] = max(out["halt_err"], _halt_err(d_last, d_prev, counts, s))
            out["f_err"] = max(out["f_err"], float((F - Fr).abs().max() / Fr.abs().max()))
            i, j = self.pair
            o = self.net.offsets
            si, sj = slice(o[i], o[i] + self.net.sizes[i]), slice(o[j], o[j] + self.net.sizes[j])
            scores = (Fr[si, sj] + Fr[sj, si].T) / 2.0
            known = torch.as_tensor(self.known, device=dev)
            out["rank_gap"] = max(out["rank_gap"], _rank_gap(scores, known, top, self.k))
        return out


def _halt_err(d_last, d_prev, counts, s) -> float:
    """The worst breach of the stopping rule, read on the reference's own
    residuals, over σ: a column that stopped at round k needs the k-th
    residual under σ and the one before it at σ or above."""
    sigma = s["sigma"]
    stopped = counts < s["max_iter"]
    over = torch.where(stopped, (d_last - sigma) / sigma, torch.zeros_like(d_last))
    under = torch.where(stopped & torch.isfinite(d_prev), (sigma - d_prev) / sigma,
                        torch.zeros_like(d_prev))
    return max(0.0, float(over.max()), float(under.max()))


def _describe(first: str, second: str, parts) -> str:
    """Host seconds a call, in its two parts, over the window and over the
    window's two halves."""
    p = np.asarray(parts, dtype=np.float64).reshape(-1, 2)
    n, h = len(p), len(p) // 2
    tot = p.sum(axis=1)
    halves = f"{float(tot[:h].mean())!r} / {float(tot[h:].mean())!r}" if h else "-"
    return (f"{n} calls; host seconds a call: {first} {float(p[:, 0].mean())!r}, {second} "
            f"{float(p[:, 1].mean())!r}; first / second half of the window {halves}")


# --------------------------------------------------------------------------
# bio_step: closed-loop dhlp-bio steps, one seed chunk each
# --------------------------------------------------------------------------
class BioStepLoop:
    def __init__(self, config, traffic, seed, device, control=False):
        from repro_torch.configs.registry import get_arch

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.parts = []
        g = config["graph"]
        self.n, self.s, self.rounds = g["num_nodes"], g["seeds"], g["rounds"]
        self.src, self.dst, self.w = graph.make(config, device)
        self.first = int(np.random.default_rng(seed).integers(self.n))
        self.dtype = torch.bfloat16 if control else torch.float32
        self.w_in = self.w.to(self.dtype)
        cell = get_arch(config["arch"]).make_cell(config["shape"])
        self.step_fn = cell.step_fn
        self.chunk = 0
        self.step_once()  # the warm call
        _sync(device)

    def _seeds(self, chunk: int) -> torch.Tensor:
        return (self.first + chunk * self.s + torch.arange(self.s, device=self.device)) % self.n

    def _y(self, chunk: int) -> torch.Tensor:
        Y = torch.zeros((self.n, self.s), dtype=self.dtype, device=self.device)
        Y[self._seeds(chunk), torch.arange(self.s, device=self.device)] = 1.0
        return Y

    def step_once(self, tracer=_UNTRACED):
        t0 = time.perf_counter()
        Y = self._y(self.chunk)
        t1 = time.perf_counter()
        with tracer.span("step"):
            out = self.step_fn(self.src, self.dst, self.w_in, Y, Y.clone())
            _sync(self.device)
        self.parts.append((t1 - t0, time.perf_counter() - t1))
        chunk = self.chunk
        self.chunk += 1
        return chunk, out

    def window(self, seconds, tracer, done=None):
        done = done or world.Until(seconds)
        keep = _Reservoir(self.seed)
        self.parts = []
        n = 0
        t0 = time.perf_counter()
        while True:
            item = self.step_once(tracer)
            n += 1
            keep.offer(item)
            last = item
            if done(t0):
                break
        self.elapsed = time.perf_counter() - t0
        self.steps = n
        self.kept = [keep.item] if keep.item is last else [keep.item, last]
        return {"attempted": n, "failed": 0}

    def end_to_end(self) -> Dict[str, float]:
        return {self.traffic["metric"]: self.elapsed / self.steps}

    def describe(self) -> str:
        return _describe("labels", "step", self.parts)

    def counters(self) -> dict:
        return {"bio.steps": self.steps, "bio.rounds": self.rounds, "bio.n": self.n,
                "bio.nnz": int(torch.count_nonzero(self.w)), "bio.s": self.s}

    def check(self) -> Dict[str, float]:
        """Every column of the kept steps, ``check_chunk`` columns at a time."""
        got = self.kept
        del self.kept, self.step_fn, self.w_in
        _free(self.device)
        beta2 = (1.0 - self.config["solver"]["alpha"]) ** 2
        step = self.traffic["check_chunk"]
        W = ref.csr_operator(self.src, self.dst, self.w, self.n)
        err = 0.0
        for chunk, out in got:
            seeds = self._seeds(chunk)
            for c0 in range(0, self.s, step):
                k = min(step, self.s - c0)
                Y = torch.zeros((self.n, k), dtype=ref.F64, device=self.device)
                Y[seeds[c0 : c0 + k], torch.arange(k, device=self.device)] = 1.0
                Fr = ref.bio_rounds(W, Y, rounds=self.rounds, beta2=beta2)
                F = out[:, c0 : c0 + k].double()
                err = max(err, float((F - Fr).abs().max() / Fr.abs().max()))
                del Y, Fr, F
        return {"f_err": err}


KINDS = {"solve": SolveLoop, "bio_step": BioStepLoop}
