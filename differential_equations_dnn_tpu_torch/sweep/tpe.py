"""Tree-structured Parzen Estimator (TPE): the adaptive ask/tell sampler.

The reference's sweep is OptunaSearch, Optuna's univariate TPE, under an
ASHA scheduler (optimize_heat_ray.py:179-181). This is its model-based
half: a pure-numpy host-side ask/tell loop (Bergstra et al. 2011,
"Algorithms for Hyper-Parameter Optimization") whose proposals the fused
tier (sweep/search.py) trains on the card. A copy of the JAX package's
sweep/tpe.py: the same draws from the same seed and observations.

Per dimension (univariate, like Optuna's default):

* observations are split into good/bad by the γ-quantile of the score;
* continuous dims (``uniform``/``loguniform``) model each group with a
  Gaussian kernel-density estimate in the transformed (log where
  appropriate) space, bandwidth per Scott's rule floored at 1% of the range;
* integer dims (``randint``) ride the continuous path and round;
* categorical dims (``choice``) use add-one-smoothed empirical frequencies;
* candidates are drawn from the good-group density l(x) and ranked by the
  acquisition ratio l(x)/g(x); ``ask`` returns the top points.
"""

from dataclasses import dataclass

import numpy as np

from differential_equations_dnn_tpu_torch.sweep.search import (
    SearchSpace,
    choice,
    loguniform,
    randint,
    uniform,
)


def _transform(spec, x):
    if isinstance(spec, loguniform):
        return np.log(x)
    return np.asarray(x, float)


def _untransform(spec, z):
    if isinstance(spec, loguniform):
        x = np.exp(z)
        return np.clip(x, spec.low, spec.high)
    if isinstance(spec, uniform):
        return np.clip(z, spec.low, spec.high)
    if isinstance(spec, randint):
        return np.clip(np.rint(z), spec.low, spec.high - 1).astype(np.int64)
    raise TypeError(spec)


def _bounds(spec):
    if isinstance(spec, loguniform):
        return np.log(spec.low), np.log(spec.high)
    if isinstance(spec, uniform):
        return spec.low, spec.high
    if isinstance(spec, randint):
        return float(spec.low), float(spec.high - 1)
    raise TypeError(spec)


def _kde_logpdf(z, centers, bandwidth, lo, hi):
    """log density of a Gaussian mixture over ``centers`` (shared bandwidth,
    equal weights) blended with ONE uniform-prior component over [lo, hi].

    The prior component (weight 1/(n+1), as in Optuna's TPE) keeps both
    densities supported over the whole range — without it the acquisition
    ratio degenerates to pure exploitation around the incumbent."""
    d = (z[:, None] - centers[None, :]) / bandwidth
    log_k = -0.5 * d * d - np.log(bandwidth * np.sqrt(2 * np.pi))
    prior = np.full((len(z), 1), -np.log(max(hi - lo, 1e-12)))
    log_k = np.concatenate([log_k, prior], axis=1)
    m = log_k.max(axis=1, keepdims=True)
    return (m[:, 0] + np.log(np.mean(np.exp(log_k - m), axis=1)))


def _scott_bandwidth(centers, lo, hi):
    n = len(centers)
    spread = np.std(centers) if n > 1 else 0.0
    bw = 1.06 * spread * n ** (-0.2) if spread > 0 else 0.0
    return max(bw, 0.01 * (hi - lo), 1e-12)


@dataclass
class TPESampler:
    """Ask/tell sampler over a ``SearchSpace``.

    ``ask(n)`` proposes n configs (random until ``n_initial`` observations
    exist); ``tell(configs, scores)`` records results (score minimised)."""

    space: SearchSpace
    seed: int = 0
    gamma: float = 0.10          # good-group quantile (Optuna-style small γ:
                                 # a larger one lets repeated mediocre scores
                                 # pollute the good model and trap the search)
    n_initial: int = 4           # random bootstrap observations
    n_candidates: int = 64       # l(x) draws ranked by l/g per proposal batch
    min_dist: float = 0.05       # forced-diversity radius, fraction of each
                                 # dim's (transformed) range: never re-evaluate
                                 # within it of an observed/pending config —
                                 # repeats are pure waste on a deterministic
                                 # objective (validated on a synthetic basin:
                                 # this is what makes TPE beat random at 10-30
                                 # trial budgets)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._configs: list[dict] = []
        self._scores: list[float] = []
        self._pending: list[dict] = []

    # -- protocol -------------------------------------------------------------

    def tell(self, configs, scores):
        for c, s in zip(configs, scores):
            self._configs.append(dict(c))
            self._scores.append(float(s) if np.isfinite(s) else np.inf)

    def ask(self, n: int = 1) -> list[dict]:
        if len(self._scores) < self.n_initial:
            draws = self.space.sample(int(self._rng.integers(1 << 31)), n)
            return [{k: v[i] for k, v in draws.items()} for i in range(n)]
        # Batch mode: earlier proposals of the same batch count as "seen" for
        # the diversity radius even before their scores are told.
        self._pending = []
        out = []
        for _ in range(n):
            cfg = self._ask_one()
            out.append(cfg)
            self._pending.append(cfg)
        self._pending = []
        return out

    # -- TPE proposal ----------------------------------------------------------

    def _split(self):
        scores = np.asarray(self._scores)
        order = np.argsort(scores, kind="stable")
        n_good = max(1, int(np.ceil(self.gamma * len(scores))))
        return order[:n_good], order[n_good:]

    def _ask_one(self) -> dict:
        good, bad = self._split()
        out = None
        for _ in range(4):
            out = {}
            for name, spec in self.space.specs.items():
                obs = np.asarray([c[name] for c in self._configs])
                if isinstance(spec, choice):
                    out[name] = self._propose_categorical(spec, obs, good, bad)
                else:
                    out[name] = self._propose_continuous(spec, obs, good, bad)
            if not self._is_duplicate(out):
                return out
        # Re-evaluating an already-observed config wastes the trial (the
        # objective is deterministic per config under vmapped training);
        # after repeated near-duplicates, take an exploration draw.
        draws = self.space.sample(int(self._rng.integers(1 << 31)), 1)
        return {k: v[0] for k, v in draws.items()}

    def _is_duplicate(self, cfg) -> bool:
        """Within ``min_dist`` (per-dim transformed range fraction) of any
        observed or same-batch-pending config."""
        for seen in self._configs + self._pending:
            same = True
            for name, spec in self.space.specs.items():
                if isinstance(spec, choice):
                    if cfg[name] != seen[name]:
                        same = False
                        break
                    continue
                lo, hi = _bounds(spec)
                a = _transform(spec, cfg[name])
                b = _transform(spec, seen[name])
                if abs(a - b) > self.min_dist * (hi - lo):
                    same = False
                    break
            if same:
                return True
        return False

    def _propose_continuous(self, spec, obs, good, bad):
        lo, hi = _bounds(spec)
        zg = _transform(spec, obs[good])
        zb = _transform(spec, obs[bad]) if len(bad) else np.array([
            0.5 * (lo + hi)])
        bw_g = _scott_bandwidth(zg, lo, hi)
        bw_b = _scott_bandwidth(zb, lo, hi)
        # Sample candidates from l(x) — a good center plus kernel noise, or
        # the uniform prior component with its mixture weight (exploration).
        # Out-of-range draws are REDRAWN uniformly rather than clipped:
        # clipping piles candidates onto the bounds and the acquisition
        # argmax then latches onto a boundary spike.
        n = self.n_candidates
        centers = zg[self._rng.integers(0, len(zg), n)]
        cand = centers + self._rng.normal(0.0, bw_g, n)
        from_prior = (self._rng.random(n) < 1.0 / (len(zg) + 1))
        redraw = from_prior | (cand < lo) | (cand > hi)
        cand = np.where(redraw, self._rng.uniform(lo, hi, n), cand)
        score = (_kde_logpdf(cand, zg, bw_g, lo, hi)
                 - _kde_logpdf(cand, zb, bw_b, lo, hi))
        return _untransform(spec, cand[int(np.argmax(score))])

    def _propose_categorical(self, spec, obs, good, bad):
        values = list(spec.values)
        idx = {v: i for i, v in enumerate(values)}

        def smoothed(group):
            counts = np.ones(len(values))
            for v in obs[group]:
                counts[idx[v]] += 1
            return counts / counts.sum()

        pl, pg = smoothed(good), smoothed(bad)
        # Draw candidates from l, rank by l/g.
        cand = self._rng.choice(len(values), self.n_candidates, p=pl)
        ratio = np.log(pl[cand]) - np.log(pg[cand])
        return values[int(cand[np.argmax(ratio)])]
