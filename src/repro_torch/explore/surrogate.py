"""Surrogate-gated evaluation over the fleet cache — the port of
``repro.explore.surrogate``.

The fleet cache holds every (design encoding, workload embedding) ->
4-metric evaluation the fleet has paid for: a free training set for an
ensemble-MLP surrogate that lets the gated NSGA run (``nsga.
make_nsga_gated``) skip the exact evaluation of candidates the surrogate
ranks as hopeless.

* ``harvest_rows`` — walk the manifest's ``export_index``, load each
  cached archive and stack its ``ParetoArchive.export_rows`` output with
  the problem's workload embedding appended: ``X = [flatten_design |
  embedding]``, ``Y = raw 4-metric rows``.
* ``fit_surrogate`` — normalize (zero-variance guarded), bootstrap-
  resample one dataset per ensemble member and train all members at once:
  full-batch Adam with the reference's bias corrections, gradients through
  autograd, on the caller's device.  Ensemble spread is the uncertainty
  signal.
* ``Surrogate`` — the fitted model: ``predict`` (log-metric mean / std),
  ``disagreement`` (mean normalized ensemble std), ``scan_arrays`` (the
  tensors the gated run consumes), ``digest`` (checkpoint identity).
* ``NonlinearTrustModel`` / ``fit_nonlinear_trust`` — the same MLP on the
  manifest's transfer-outcome table, which replaces the ridge
  ``TrustModel`` once ``NONLINEAR_TRUST_MIN`` records exist.  Host-side,
  on the CPU, like the ridge fit it replaces.

Parameters are kept as numpy (a member axis leading every leaf), so the
digest, the checkpoint signature and ``convert.surrogate_from_reference``
see the same bytes whatever device fitted them.  The member products are
``torch.matmul`` / ``torch.bmm``: the reference computes them outside any
Pallas kernel too.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..runtime import generator, resolve_device

F = torch.float32

# transfer-outcome records needed before the non-linear trust head takes
# over from the ridge TrustModel (below it, a 2-layer MLP just memorizes)
NONLINEAR_TRUST_MIN = 32

_EPS = 1e-8
_METRIC_FLOOR = 1e-6        # raw metrics are positive; the clip only
#                             guards degenerate / penalized rows
_WEIGHT_KEYS = ("W1", "b1", "W2", "b2", "W3", "b3")


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    """Gating + fitting knobs (the reference's, field for field).

    ``exact_frac`` of each generation's candidate children get exact
    evaluations; ``beta`` sets LCB optimism (predicted mean - beta x
    ensemble std); ``tau`` is the per-candidate normalized disagreement
    above which a candidate is FORCED into the exact slots;
    ``fallback_tau`` is the segment-mean disagreement above which the
    service abandons the surrogate for the rest of the run.  ``min_rows``
    gates fitting itself: below it the query runs the exact path,
    bit-identical to no surrogate."""
    exact_frac: float = 0.5
    beta: float = 1.0
    tau: float = 1.0
    fallback_tau: float = 1.5
    min_rows: int = 64
    members: int = 4
    hidden: int = 48
    epochs: int = 300
    lr: float = 3e-3
    seed: int = 0

    def n_exact(self, pop: int) -> int:
        """Exact-evaluation slots per generation for a ``pop``-wide
        candidate batch: at least 1, at most the whole batch."""
        return min(max(int(round(pop * self.exact_frac)), 1), pop)


# ---------------------------------------------------------------------------
# ensemble MLP core (shared by the metric surrogate and the trust head)
# ---------------------------------------------------------------------------
def _init_params(gen: torch.Generator, members: int, din: int, hidden: int,
                 dout: int, device) -> Dict[str, torch.Tensor]:
    """He-scaled normal weights and zero biases, every leaf with a leading
    member axis (the reference's initializer; another random stream)."""
    s1 = float(np.sqrt(2.0 / din))
    s2 = float(np.sqrt(2.0 / hidden))

    def normal(shape, scale):
        return torch.randn((members, *shape), generator=gen,
                           device=device) * scale
    return dict(W1=normal((din, hidden), s1),
                b1=torch.zeros(members, hidden, device=device),
                W2=normal((hidden, hidden), s2),
                b2=torch.zeros(members, hidden, device=device),
                W3=normal((hidden, dout), s2),
                b3=torch.zeros(members, dout, device=device))


def ensemble_forward(params: Dict, Xn: torch.Tensor) -> torch.Tensor:
    """(M, n, dout) member outputs for normalized inputs ``Xn`` (n, din),
    or (M, n, din) one set per member: two tanh hidden layers and a linear
    head per member, ``params`` leaves carrying a leading member axis (the
    reference's ``ensemble_forward``, which the gated NSGA run inlines)."""
    h = torch.tanh(torch.matmul(Xn, params["W1"]) + params["b1"][:, None])
    h = torch.tanh(torch.bmm(h, params["W2"]) + params["b2"][:, None])
    return torch.bmm(h, params["W3"]) + params["b3"][:, None]


def _fit_ensemble(Xn, Yn, members: int, hidden: int, epochs: int, lr: float,
                  seed: int, device="cuda", params=None, idx=None
                  ) -> Dict[str, np.ndarray]:
    """Train ``members`` MLPs on bootstrap resamples of (Xn, Yn), all at
    once: full-batch Adam (beta1 0.9, beta2 0.999, eps 1e-8, the reference's
    bias corrections in float32) on each member's mean squared error.
    ``params`` (initial weights, numpy or tensors) and ``idx`` ((members,
    n) bootstrap rows) replace the draws from ``seed`` when given — the
    tests pass the reference's.  Returns numpy parameters."""
    dev = resolve_device(device)
    Xn = torch.as_tensor(np.asarray(Xn, np.float32), device=dev)
    Yn = torch.as_tensor(np.asarray(Yn, np.float32), device=dev)
    n, din = Xn.shape
    dout = Yn.shape[1]
    gen = generator(seed, dev)
    if params is None:
        params = _init_params(gen, members, din, hidden, dout, dev)
    if idx is None:
        idx = torch.randint(0, n, (members, n), generator=gen, device=dev)
    p = {k: torch.as_tensor(np.array(v) if not torch.is_tensor(v) else v,
                            dtype=F, device=dev).clone().requires_grad_(True)
         for k, v in params.items()}
    idx = torch.as_tensor(np.array(idx) if not torch.is_tensor(idx)
                          else idx, device=dev).long()
    Xb, Yb = Xn[idx], Yn[idx]                     # (M, n, din), (M, n, dout)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1 = torch.tensor(0.9, dtype=F, device=dev)
    b2 = torch.tensor(0.999, dtype=F, device=dev)
    for t in range(epochs):
        out = ensemble_forward(p, Xb)
        loss = ((out - Yb) ** 2).mean(dim=(1, 2)).sum()   # members apart
        grads = torch.autograd.grad(loss, [p[k] for k in _WEIGHT_KEYS])
        step = torch.tensor(t + 1, dtype=F, device=dev)
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for k, g in zip(_WEIGHT_KEYS, grads):
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g ** 2
                p[k] -= lr * (m[k] / c1) / (torch.sqrt(v2[k] / c2) + 1e-8)
    return {k: v.detach().cpu().numpy() for k, v in p.items()}


def _forward_np(params: Dict[str, np.ndarray], Xn) -> torch.Tensor:
    """``ensemble_forward`` on the CPU for numpy parameters and inputs."""
    return ensemble_forward({k: torch.as_tensor(v) for k, v in params.items()},
                            torch.as_tensor(np.asarray(Xn, np.float32)))


# ---------------------------------------------------------------------------
# the metric surrogate
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Surrogate:
    """A fitted ensemble surrogate: (design encoding | workload embedding)
    -> log 4-metric vector, ensemble spread as the uncertainty signal.
    ``params`` leaves carry a leading member axis; normalization
    statistics make it portable across metric scales (zero-variance
    columns normalize to exactly 0, never NaN)."""
    params: Dict[str, np.ndarray]
    x_mean: np.ndarray
    x_std: np.ndarray
    y_mean: np.ndarray
    y_std: np.ndarray
    config: SurrogateConfig
    n_rows: int

    def _out(self, X) -> torch.Tensor:
        Xn = (np.asarray(X, np.float32) - self.x_mean) / self.x_std
        return _forward_np(self.params, Xn)

    def predict(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, std) of the predicted LOG-metric vectors, (n, n_obj)
        each — std is the de-normalized ensemble spread."""
        out = self._out(X)
        mean = out.mean(0).numpy() * self.y_std + self.y_mean
        std = out.std(0, correction=0).numpy() * self.y_std
        return mean, std

    def disagreement(self, X) -> np.ndarray:
        """(n,) mean NORMALIZED ensemble std per candidate — the scale-free
        signal the gate thresholds (``config.tau``)."""
        return self._out(X).std(0, correction=0).mean(-1).numpy()

    def scan_arrays(self, embedding, device="cuda") -> Dict[str, torch.Tensor]:
        """The tensors the gated NSGA run consumes, on ``device``: the
        ensemble weights, the input normalization and this problem's
        workload embedding."""
        dev = resolve_device(device)
        d = {k: torch.as_tensor(v, dtype=F, device=dev)
             for k, v in self.params.items()}
        d["x_mean"] = torch.as_tensor(self.x_mean, dtype=F, device=dev)
        d["x_std"] = torch.as_tensor(self.x_std, dtype=F, device=dev)
        d["emb"] = torch.as_tensor(np.asarray(embedding, np.float32).ravel(),
                                   device=dev)
        return d

    def digest(self) -> str:
        """Content hash of the fitted model — part of the resume-checkpoint
        signature: a checkpoint written under a different surrogate
        answers a different numeric stream."""
        h = hashlib.sha256()
        for k in sorted(self.params):
            h.update(k.encode())
            h.update(np.ascontiguousarray(self.params[k]).tobytes())
        for a in (self.x_mean, self.x_std, self.y_mean, self.y_std):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(repr(self.config).encode())
        return h.hexdigest()[:16]


def _norm_stats(A) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) with the zero-variance guard: constant columns get
    std 1, so they normalize to exactly 0 instead of NaN."""
    mean = A.mean(axis=0)
    std = A.std(axis=0)
    return mean.astype(np.float32), np.where(
        std < _EPS, 1.0, std).astype(np.float32)


def fit_surrogate(X, Y, cfg: SurrogateConfig = SurrogateConfig(),
                  seed: Optional[int] = None,
                  device="cuda") -> Optional[Surrogate]:
    """Fit the ensemble on harvested rows: ``X`` (n, din) float design
    encodings + embeddings, ``Y`` (n, n_obj) RAW metric rows (trained in
    log space — the scale the NSGA selection ranks on), on ``device``.
    ``None`` below ``cfg.min_rows`` usable rows; non-finite rows are
    dropped.  ``seed`` defaults to ``cfg.seed``."""
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y, np.float64)
    if X.ndim != 2 or Y.ndim != 2 or X.shape[0] != Y.shape[0]:
        raise ValueError(f"bad dataset shapes {X.shape} / {Y.shape}")
    ylog = np.log(np.maximum(Y, _METRIC_FLOOR))
    ok = np.all(np.isfinite(X), axis=1) & np.all(np.isfinite(ylog), axis=1)
    X, ylog = X[ok], ylog[ok]
    if X.shape[0] < max(int(cfg.min_rows), 2):
        return None
    x_mean, x_std = _norm_stats(X)
    y_mean, y_std = _norm_stats(ylog)
    Xn = (X - x_mean) / x_std
    Yn = ((ylog - y_mean) / y_std).astype(np.float32)
    with obs.span("surrogate.fit", rows=int(X.shape[0]),
                  members=cfg.members):
        params = _fit_ensemble(Xn, Yn, cfg.members, cfg.hidden, cfg.epochs,
                               cfg.lr, cfg.seed if seed is None else seed,
                               device=device)
    obs.inc("explore.surrogate.fits")
    obs.inc("explore.surrogate.rows", int(X.shape[0]))
    return Surrogate(params=params, x_mean=x_mean, x_std=x_std,
                     y_mean=y_mean.astype(np.float32), y_std=y_std,
                     config=cfg, n_rows=int(X.shape[0]))


def harvest_rows(index: Sequence[Tuple[str, np.ndarray]],
                 load_archive: Callable[[str], Optional[object]],
                 design_dim: int, embed_dim: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble the surrogate training set from cached archives.

    ``index`` is ``ArchiveManifest.export_index`` output; ``load_archive``
    resolves a key to a ``ParetoArchive`` (or ``None``: broken or absent
    archives are skipped, counted on ``explore.surrogate.skipped_archives``).
    Archives whose design encoding or embedding dimension disagrees with
    the target problem's are skipped the same way.  Returns ``X`` (n, design_dim + embed_dim) float32 and ``Y`` (n,
    n_obj) float64 raw metrics."""
    Xs: List[np.ndarray] = []
    Ys: List[np.ndarray] = []
    skipped = 0
    for key, emb in index:
        emb = np.asarray(emb, np.float64).ravel()
        if emb.size != embed_dim:
            skipped += 1
            continue
        arc = load_archive(key)
        if arc is None:
            skipped += 1
            continue
        Xd, Y = arc.export_rows()
        if Xd.shape[1] != design_dim:
            skipped += 1
            continue
        if not len(Xd):
            continue
        Xs.append(np.concatenate(
            [Xd, np.tile(emb.astype(np.float32), (len(Xd), 1))], axis=1))
        Ys.append(Y)
    if skipped:
        obs.inc("explore.surrogate.skipped_archives", skipped)
    if not Xs:
        return (np.zeros((0, design_dim + embed_dim), np.float32),
                np.zeros((0, 4), np.float64))
    return np.concatenate(Xs), np.concatenate(Ys)


# ---------------------------------------------------------------------------
# the non-linear transfer-trust head
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class NonlinearTrustModel:
    """MLP lift model over |embedding delta| features — the deep-record
    replacement for the ridge ``TrustModel``, same contract: ``predict``
    clamps at 0 and answers dimension-mismatched deltas with a neutral
    0.0."""
    params: Dict[str, np.ndarray]
    x_mean: np.ndarray
    x_std: np.ndarray
    y_mean: float
    y_std: float
    dim: int

    def predict(self, delta) -> float:
        d = np.abs(np.asarray(delta, np.float64).ravel())
        if d.shape[0] != self.dim:
            return 0.0
        xn = (d.astype(np.float32) - self.x_mean) / self.x_std
        out = _forward_np(self.params, xn[None])
        lift = float(out.mean()) * self.y_std + self.y_mean
        return max(lift, 0.0)


def fit_nonlinear_trust(records: Sequence[Dict],
                        dim: Optional[int] = None,
                        min_records: int = NONLINEAR_TRUST_MIN,
                        members: int = 2, hidden: int = 16,
                        epochs: int = 300, lr: float = 1e-2,
                        seed: int = 0) -> Optional[NonlinearTrustModel]:
    """Fit the non-linear trust head on transfer-outcome records (dicts
    with ``delta`` and ``lift``), modal-dim filtered exactly like
    ``fit_trust_model``, on the CPU.  ``None`` below ``min_records`` usable
    rows — the caller falls back to the ridge."""
    usable = [r for r in records
              if np.all(np.isfinite(np.asarray(r["delta"], np.float64)))
              and np.isfinite(r["lift"])]
    if not usable:
        return None
    sizes = [np.asarray(r["delta"]).size for r in usable]
    if dim is None:
        counts: Dict[int, int] = {}
        for s in sizes:
            counts[s] = counts.get(s, 0) + 1
        dim = max(counts, key=lambda s: (counts[s],
                                         max(i for i, sz in enumerate(sizes)
                                             if sz == s)))
    kept = [r for r in usable if np.asarray(r["delta"]).size == dim]
    if len(kept) < len(usable):
        obs.inc("explore.trust.skipped_records", len(usable) - len(kept))
    if len(kept) < max(int(min_records), 2):
        return None
    X = np.stack([np.abs(np.asarray(r["delta"], np.float64).ravel())
                  for r in kept]).astype(np.float32)
    y = np.asarray([float(r["lift"]) for r in kept], np.float64)[:, None]
    x_mean, x_std = _norm_stats(X)
    y_mean, y_std = _norm_stats(y)
    Xn = (X - x_mean) / x_std
    Yn = ((y - y_mean) / y_std).astype(np.float32)
    params = _fit_ensemble(Xn, Yn, members, hidden, epochs, lr, seed,
                           device="cpu")
    obs.inc("explore.trust.nonlinear_fits")
    return NonlinearTrustModel(params=params, x_mean=x_mean, x_std=x_std,
                               y_mean=float(y_mean[0]),
                               y_std=float(y_std[0]), dim=int(dim))
