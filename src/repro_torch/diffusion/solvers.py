"""SamplerPolicy — pluggable few-step solvers and phase-scheduled policies
(port of ``repro.diffusion.solvers``).

``SamplerPolicy``   — frozen/hashable: which solver (``ddim`` | ``dpm2m`` |
                      ``plms``), how many steps, an optional
                      ``PhaseSchedule`` and the timestep spacing.  A *bank*
                      is a tuple of distinct policies; per-row integer
                      ``policy_id`` s select each row's coefficients.
``PhaseSchedule``   — per-phase overrides (TIPS activity, PSSA / TIPS /
                      reuse threshold scales), resolved per row per step
                      from the tables.
``solver_tables``   — the (P, N) per-(policy, step) tables that
                      ``sampler.denoise_step`` gathers per row: timesteps,
                      DDIM alphas, DPM-Solver++(2M) coefficients, TIPS
                      activity and the phase threshold scales.

Exactness (DESIGN.md §10): the DDIM columns are gathers of the SAME
float32 ``alphas_cumprod`` tensor the legacy path uses, on the same
device, and the transfer is the shared ``ddim_transfer``, so a
single-policy ``(ddim, 25)`` bank is bit-identical to the policy-free
path.  A row's arithmetic depends only on its own (solver, steps) pair:
candidates are computed elementwise for every family in the bank and
selected per row.

Solvers:

* ``ddim``  — deterministic eta=0 transfer.
* ``plms``  — PNDM's linear multistep: Adams–Bashforth over the last <= 4
  eps (warmup orders 1/2/3/4), then the DDIM transfer.  History: 3 eps.
* ``dpm2m`` — DPM-Solver++(2M) in data-prediction space, with
  ``lambda = log(alpha/sigma)``, ``h_i = lambda_{i+1} - lambda_i`` and
  ``m2 = h_i / (2 h_{i-1})``:
  ``x_{i+1} = (sigma_{i+1}/sigma_i) x_i
  - alpha_{i+1} (e^{-h_i} - 1) [(1 + m2) x0_i - m2 x0_{i-1}]``,
  ``m2 = 0`` on the first and the final step (lower-order-final: the
  final sigma is 0, h = inf and ``expm1(-inf) = -1`` lands the step on
  the data prediction).  History: 1 x0.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

SOLVERS = ("ddim", "plms", "dpm2m")
# timestep spacing over the training trajectory (SamplerPolicy.schedule)
SCHEDULES = ("uniform", "karras")
KARRAS_RHO = 7.0
# per-row solver family ids inside the coefficient tables
SOLVER_ID = {name: i for i, name in enumerate(SOLVERS)}
# previous-step model outputs each family reads (eps for plms, x0 for dpm2m)
SOLVER_HISTORY = {"ddim": 0, "plms": 3, "dpm2m": 1}

# Adams–Bashforth eps weights by available history (PNDM's warmup orders);
# row h weighs [eps_t, eps_{t-1}, eps_{t-2}, eps_{t-3}]
PLMS_WEIGHTS = (
    (1.0, 0.0, 0.0, 0.0),
    (3.0 / 2.0, -1.0 / 2.0, 0.0, 0.0),
    (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0, 0.0),
    (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0),
)


def _triple(val, kind=float) -> tuple:
    t = tuple(val)
    if len(t) != 3:
        raise ValueError(f"phase schedules have 3 phases, got {val!r}")
    return tuple(kind(v) for v in t)


@dataclasses.dataclass(frozen=True)
class PhaseSchedule:
    """Per-phase policy overrides over the denoising trajectory.

    Phases follow SD-Acc's structure -> content -> detail split: step ``i``
    of an ``n``-step trajectory is in phase 0 while ``i < ceil(b0*n)``,
    phase 1 while ``i < ceil(b1*n)``, else phase 2.  ``tips_on`` replaces
    the ``tips_active_iters`` window with per-phase TIPS activity; the
    ``*_scale`` triples MULTIPLY the static thresholds
    (``UNetConfig.pssa_threshold``, ``PrecisionPolicy.threshold``,
    ``ReusePolicy.threshold``) per phase.
    """
    boundaries: Tuple[float, float] = (0.4, 0.8)
    tips_on: Tuple[bool, bool, bool] = (True, True, False)
    pssa_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    tips_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    reuse_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    def __post_init__(self):
        b0, b1 = self.boundaries
        if not 0.0 <= b0 <= b1 <= 1.0:
            raise ValueError(
                f"PhaseSchedule.boundaries={self.boundaries}: expected "
                f"0 <= b0 <= b1 <= 1")
        for fname in ("pssa_scale", "tips_scale", "reuse_scale"):
            if any(s <= 0.0 for s in getattr(self, fname)):
                raise ValueError(
                    f"PhaseSchedule.{fname}={getattr(self, fname)}: "
                    f"threshold scales must be > 0")

    @classmethod
    def detail_guard(cls) -> "PhaseSchedule":
        """TIPS off in the detail phase, PSSA pruned harder while features
        are coarse, the reuse threshold relaxed mid-trajectory."""
        return cls(tips_on=(True, True, False),
                   pssa_scale=(2.0, 2.0, 1.0),
                   reuse_scale=(1.0, 2.0, 1.0))

    @classmethod
    def parse(cls, spec: str) -> "PhaseSchedule":
        """``"detail_guard"`` or ``key=v0:v1[:v2]`` items, e.g.
        ``"boundaries=0.3:0.8,pssa=2:2:1,tips=on:on:off"``."""
        spec = spec.strip()
        if spec in ("detail_guard", "default"):
            return (cls.detail_guard() if spec == "detail_guard" else cls())
        fields = {}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            if "=" not in item:
                raise ValueError(
                    f"phase spec {item!r}: expected key=v0:v1[:v2] or "
                    f"'detail_guard'")
            key, val = (s.strip() for s in item.split("=", 1))
            parts = val.split(":")
            if key == "boundaries":
                if len(parts) != 2:
                    raise ValueError(
                        f"phase spec: boundaries={val!r} (expected b0:b1)")
                fields["boundaries"] = (float(parts[0]), float(parts[1]))
            elif key == "tips":
                fields["tips_on"] = _triple(
                    (p.lower() in ("on", "true", "1") for p in parts), bool)
            elif key in ("pssa", "tips_scale", "reuse"):
                name = {"pssa": "pssa_scale", "tips_scale": "tips_scale",
                        "reuse": "reuse_scale"}[key]
                fields[name] = _triple((float(p) for p in parts))
            else:
                raise ValueError(
                    f"phase spec: unknown key {key!r} (expected boundaries, "
                    f"tips, pssa, tips_scale or reuse)")
        return cls(**fields)

    def phase_of(self, i: int, num_steps: int) -> int:
        """Which phase step ``i`` of a ``num_steps`` trajectory is in."""
        b0, b1 = self.boundaries
        if i < math.ceil(b0 * num_steps):
            return 0
        if i < math.ceil(b1 * num_steps):
            return 1
        return 2

    @property
    def schedules_pssa(self) -> bool:
        return self.pssa_scale != (1.0, 1.0, 1.0)

    @property
    def schedules_tips_threshold(self) -> bool:
        return self.tips_scale != (1.0, 1.0, 1.0)

    @property
    def schedules_reuse(self) -> bool:
        return self.reuse_scale != (1.0, 1.0, 1.0)

    def describe(self) -> dict:
        return {"boundaries": list(self.boundaries),
                "tips_on": list(self.tips_on),
                "pssa_scale": list(self.pssa_scale),
                "tips_scale": list(self.tips_scale),
                "reuse_scale": list(self.reuse_scale)}


@dataclasses.dataclass(frozen=True)
class SamplerPolicy:
    """Frozen/hashable per-request sampling decision.

    ``name`` is a display label, excluded from equality and hash.
    ``schedule`` spaces the budget's timesteps: ``"uniform"`` (the legacy
    equispaced grid) or ``"karras"`` (the rho=7 sigma ramp of Karras et
    al. 2022, snapped to the nearest training timesteps so the
    ``alphas_cumprod`` gathers stay exact).
    """
    solver: str = "ddim"
    num_steps: int = 25
    phases: Optional[PhaseSchedule] = None
    schedule: str = "uniform"
    name: str = dataclasses.field(default="", compare=False)

    def __post_init__(self):
        if self.solver not in SOLVERS:
            raise ValueError(
                f"SamplerPolicy.solver={self.solver!r}: expected one of "
                f"{SOLVERS}")
        if self.num_steps < 1:
            raise ValueError(
                f"SamplerPolicy.num_steps={self.num_steps}: expected >= 1")
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"SamplerPolicy.schedule={self.schedule!r}: expected one "
                f"of {SCHEDULES}")

    @classmethod
    def ddim(cls, num_steps: int = 25, **kw) -> "SamplerPolicy":
        return cls(solver="ddim", num_steps=num_steps, **kw)

    @classmethod
    def dpm2m(cls, num_steps: int = 12, **kw) -> "SamplerPolicy":
        return cls(solver="dpm2m", num_steps=num_steps, **kw)

    @classmethod
    def plms(cls, num_steps: int = 12, **kw) -> "SamplerPolicy":
        return cls(solver="plms", num_steps=num_steps, **kw)

    @classmethod
    def tier(cls, name: str) -> "SamplerPolicy":
        """Quality-tier presets for serving admission."""
        try:
            return TIERS[name]
        except KeyError:
            raise ValueError(
                f"unknown quality tier {name!r}: expected one of "
                f"{tuple(TIERS)}") from None

    @classmethod
    def parse(cls, spec: str) -> "SamplerPolicy":
        """A tier name, a solver name, or a comma list with ``steps=N`` /
        ``schedule=uniform|karras`` / ``phases=<PhaseSchedule spec with ;
        separators>`` / ``name=`` overrides, e.g.
        ``"dpm2m,steps=10,schedule=karras,phases=detail_guard"``."""
        spec = spec.strip()
        if spec in TIERS:
            return TIERS[spec]
        solver = None
        fields: dict = {}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            if item in SOLVERS:
                solver = item
                continue
            if "=" not in item:
                raise ValueError(
                    f"sampler spec {item!r}: expected a tier in "
                    f"{tuple(TIERS)}, a solver in {SOLVERS} or key=value")
            key, val = (s.strip() for s in item.split("=", 1))
            if key == "steps":
                fields["num_steps"] = int(val)
            elif key == "solver":
                solver = val
            elif key == "schedule":
                fields["schedule"] = val
            elif key == "phases":
                fields["phases"] = PhaseSchedule.parse(val.replace(";", ","))
            elif key == "name":
                fields["name"] = val
            else:
                raise ValueError(
                    f"sampler spec: unknown key {key!r} (expected steps, "
                    f"solver, schedule, phases or name)")
        base = cls() if solver is None else cls(solver=solver)
        return dataclasses.replace(base, **fields) if fields else base

    @property
    def solver_id(self) -> int:
        return SOLVER_ID[self.solver]

    @property
    def history(self) -> int:
        """Previous model outputs this solver reads (the hist depth)."""
        return SOLVER_HISTORY[self.solver]

    def key(self) -> str:
        """Stable short label (bank dict keys, records)."""
        base = f"{self.solver}-{self.num_steps}"
        return base if self.schedule == "uniform" else \
            f"{base}-{self.schedule}"

    def label(self) -> str:
        return self.name or self.key()

    def describe(self) -> dict:
        return {"solver": self.solver, "num_steps": self.num_steps,
                "schedule": self.schedule, "name": self.label(),
                "phases": (None if self.phases is None
                           else self.phases.describe())}


TIERS = {
    "draft": SamplerPolicy(solver="dpm2m", num_steps=8, name="draft"),
    "balanced": SamplerPolicy(solver="dpm2m", num_steps=12, name="balanced"),
    "quality": SamplerPolicy(solver="ddim", num_steps=25, name="quality"),
}


# ----------------------------------------------------------------------------
# Bank views (a bank = a tuple of distinct SamplerPolicies)
# ----------------------------------------------------------------------------
def as_bank(policies) -> tuple:
    """Normalize to a hashable bank tuple; an empty bank raises."""
    bank = (policies,) if isinstance(policies, SamplerPolicy) \
        else tuple(policies)
    if not bank:
        raise ValueError("sampler bank is empty")
    for p in bank:
        if not isinstance(p, SamplerPolicy):
            raise TypeError(f"bank entries must be SamplerPolicy, got "
                            f"{type(p).__name__}")
    return bank


def bank_max_steps(bank) -> int:
    return max(p.num_steps for p in bank)


def bank_history(bank) -> int:
    """History depth of the slot buffer: the bank's worst case."""
    return max(p.history for p in bank)


def bank_schedules(bank) -> tuple:
    """(pssa, tips_threshold, reuse): which override lanes are live.  An
    unscheduled bank runs the exact legacy UNet call."""
    ph = [p.phases for p in bank if p.phases is not None]
    return (any(s.schedules_pssa for s in ph),
            any(s.schedules_tips_threshold for s in ph),
            any(s.schedules_reuse for s in ph))


def tips_active_schedule(policy: SamplerPolicy, ddim_cfg) -> tuple:
    """Per-step TIPS activity for one policy: the config's
    ``tips_active_iters`` scaled to the budget (exactly ``i <
    tips_active_iters`` when the budget matches), or the per-phase
    activity when the policy has phases."""
    n = policy.num_steps
    if policy.phases is not None:
        return tuple(bool(policy.phases.tips_on[policy.phases.phase_of(i, n)])
                     for i in range(n))
    if n == ddim_cfg.num_inference_steps:
        active = ddim_cfg.tips_active_iters
    else:
        active = max(1, n * ddim_cfg.tips_active_iters
                     // ddim_cfg.num_inference_steps)
    return tuple(i < active for i in range(n))


def phase_index_schedule(policy: SamplerPolicy) -> tuple:
    """Per-step phase index (0/1/2); a policy without phases uses the
    default boundaries."""
    ph = policy.phases if policy.phases is not None else PhaseSchedule()
    return tuple(ph.phase_of(i, policy.num_steps)
                 for i in range(policy.num_steps))


def _scale_schedule(policy: SamplerPolicy, field: str) -> tuple:
    ph = policy.phases
    if ph is None:
        return (1.0,) * policy.num_steps
    scales = getattr(ph, field)
    return tuple(float(scales[ph.phase_of(i, policy.num_steps)])
                 for i in range(policy.num_steps))


# ----------------------------------------------------------------------------
# Per-(policy, step) coefficient tables
# ----------------------------------------------------------------------------
class SolverTables(NamedTuple):
    """(P, N) gather tables (N = the bank's largest budget; a shorter
    policy's row repeats its final step, never read: step indices are
    clipped to each row's budget)."""
    t: torch.Tensor            # (P, N) int64 UNet timesteps
    a_t: torch.Tensor          # (P, N) f32 alphas_cumprod[t]
    a_prev: torch.Tensor       # (P, N) f32 alphas_cumprod at the next boundary
    c_lat: torch.Tensor        # (P, N) f32 dpm2m latent carry (sigma ratio)
    c_d: torch.Tensor          # (P, N) f32 dpm2m data-prediction coefficient
    m2: torch.Tensor           # (P, N) f32 dpm2m second-order weight
    tips: torch.Tensor         # (P, N) bool per-step TIPS activity
    pssa_scale: torch.Tensor   # (P, N) f32 phase threshold scales
    tips_scale: torch.Tensor   # (P, N) f32
    reuse_scale: torch.Tensor  # (P, N) f32
    solver: torch.Tensor       # (P,) int64 family id
    budget: torch.Tensor       # (P,) int64 per-policy step budget


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x, x[-1:].expand(n - x.shape[0])])


def _timesteps(policy: SamplerPolicy, ddim_cfg, acp: torch.Tensor):
    """(t, t_prev) int64 for one policy; ``t_prev < 0`` marks the final
    boundary."""
    n, dev = policy.num_steps, acp.device
    if policy.schedule == "karras":
        # the rho-ramp over sigma = sqrt((1-a)/a), snapped to the nearest
        # DISCRETE training timestep, in float32 as the JAX package
        all_sigmas = torch.sqrt((1.0 - acp) / acp)
        inv_rho = 1.0 / KARRAS_RHO
        s_max, s_min = all_sigmas[-1], all_sigmas[0]
        ramp = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=dev)
        sigmas = (s_max ** inv_rho
                  + ramp * (s_min ** inv_rho - s_max ** inv_rho)
                  ) ** KARRAS_RHO
        ts = torch.argmin(torch.abs(all_sigmas[None, :] - sigmas[:, None]),
                          dim=1)
        t_prev = torch.cat([ts[1:], torch.full((1,), -1, dtype=ts.dtype,
                                               device=dev)])
        return ts, t_prev
    step = ddim_cfg.num_train_steps // n
    ts = torch.arange(n - 1, -1, -1, device=dev) * step
    return ts, ts - step


def solver_tables(bank, ddim_cfg, device="cpu") -> SolverTables:
    """The bank's coefficient tables on ``device``, built once per (bank,
    config, device) and shared (read-only) after that.

    The DDIM columns gather the SAME float32 ``alphas_cumprod`` tensor the
    legacy path computes on that device, with the same ``where`` for the
    final boundary, so ``ddim_transfer`` sees bit-identical values.
    """
    return _solver_tables(as_bank(bank), ddim_cfg, torch.device(device))


@functools.lru_cache(maxsize=64)
def _solver_tables(bank, ddim_cfg, device) -> SolverTables:
    from repro_torch.diffusion.sampler import alphas_cumprod

    return tables_from_alphas(bank, ddim_cfg,
                              alphas_cumprod(ddim_cfg, device))


def tables_from_alphas(bank, ddim_cfg, acp: torch.Tensor) -> SolverTables:
    """:func:`solver_tables` from a given float32 ``alphas_cumprod``."""
    bank = as_bank(bank)
    n_max = bank_max_steps(bank)
    dev = acp.device
    one = torch.ones((), device=dev)
    cols: dict = {f: [] for f in SolverTables._fields
                  if f not in ("solver", "budget")}
    for p in bank:
        n = p.num_steps
        ts, t_prev = _timesteps(p, ddim_cfg, acp)
        a_t = acp[ts]
        a_prev = torch.where(t_prev >= 0, acp[torch.clamp_min(t_prev, 0)],
                             one)
        alpha_c, sigma_c = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
        alpha_n, sigma_n = torch.sqrt(a_prev), torch.sqrt(1.0 - a_prev)
        lam_c = torch.log(alpha_c / sigma_c)
        lam_n = torch.log(alpha_n / sigma_n)     # +inf at the final boundary
        h = lam_n - lam_c
        c_lat = sigma_n / sigma_c                # 0 at the final boundary
        c_d = -alpha_n * torch.expm1(-h)         # alpha_n at the final step
        i = torch.arange(n, device=dev)
        m2 = torch.where((i == 0) | (i == n - 1), torch.zeros((), device=dev),
                         h / (2.0 * torch.cat([h[:1], h[:-1]])))
        cols["t"].append(_pad_last(ts.to(torch.int64), n_max))
        for name, arr in (("a_t", a_t), ("a_prev", a_prev),
                          ("c_lat", c_lat), ("c_d", c_d), ("m2", m2)):
            cols[name].append(_pad_last(arr, n_max))
        cols["tips"].append(_pad_last(torch.tensor(
            tips_active_schedule(p, ddim_cfg), dtype=torch.bool,
            device=dev), n_max))
        for name in ("pssa_scale", "tips_scale", "reuse_scale"):
            cols[name].append(_pad_last(torch.tensor(
                _scale_schedule(p, name), dtype=torch.float32, device=dev),
                n_max))
    return SolverTables(
        solver=torch.tensor([p.solver_id for p in bank], dtype=torch.int64,
                            device=dev),
        budget=torch.tensor([p.num_steps for p in bank], dtype=torch.int64,
                            device=dev),
        **{name: torch.stack(v) for name, v in cols.items()})


class PhaseOverrides(NamedTuple):
    """Per-row threshold scales for one step: each lane is None (the bank
    never schedules it) or a (B,) float32 of multiplicative scales on the
    static policy thresholds."""
    pssa_scale: Optional[torch.Tensor] = None
    tips_scale: Optional[torch.Tensor] = None
    reuse_scale: Optional[torch.Tensor] = None


def gather_overrides(tables: SolverTables, bank, policy_id, idx
                     ) -> Optional[PhaseOverrides]:
    """Per-row override scales for the rows' current steps (or None)."""
    sched_pssa, sched_tips, sched_reuse = bank_schedules(bank)
    if not (sched_pssa or sched_tips or sched_reuse):
        return None
    return PhaseOverrides(
        pssa_scale=(tables.pssa_scale[policy_id, idx] if sched_pssa
                    else None),
        tips_scale=(tables.tips_scale[policy_id, idx] if sched_tips
                    else None),
        reuse_scale=(tables.reuse_scale[policy_id, idx] if sched_reuse
                     else None))


# ----------------------------------------------------------------------------
# The per-row solver update
# ----------------------------------------------------------------------------
def init_history(bank, batch: int, latent_shape, device="cpu"
                 ) -> torch.Tensor:
    """(B, H, *latent) zeroed solver history (H may be 0: ddim only)."""
    h = bank_history(as_bank(bank))
    return torch.zeros((batch, h) + tuple(latent_shape), dtype=torch.float32,
                       device=device)


def ddim_transfer(latents, eps, a_t, a_prev):
    """The deterministic DDIM (eta=0) transfer, coefficients pre-gathered.

    Shared by ``sampler.ddim_step`` and every banked candidate (PLMS
    applies it to its multistep eps), so the paths cannot drift apart.
    """
    x0 = (latents - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def solver_update(latents, eps, hist, tables: SolverTables, bank,
                  policy_id, idx):
    """One per-row solver step: (new_latents, new_hist).

    ``idx`` is the (B,) CLIPPED step index, ``hist`` the (B, H, ...)
    newest-first history (eps for plms rows, x0 for dpm2m rows, selected
    per row on write).  Candidates are computed for every family in the
    bank and selected per row, so each row's arithmetic equals a
    single-policy run of its own (solver, steps) pair.
    """
    bank = as_bank(bank)
    fams = {p.solver for p in bank}
    b = latents.shape[0]
    shape = (b,) + (1,) * (latents.ndim - 1)
    a_t = tables.a_t[policy_id, idx].reshape(shape)
    a_prev = tables.a_prev[policy_id, idx].reshape(shape)
    hmax = bank_history(bank)

    cands: dict = {}
    store: dict = {}
    if "ddim" in fams:
        cands["ddim"] = ddim_transfer(latents, eps, a_t, a_prev)
        store["ddim"] = eps                   # never read (history 0)
    if "plms" in fams:
        w = torch.tensor(PLMS_WEIGHTS, dtype=torch.float32,
                         device=latents.device)[torch.clamp_max(idx, 3)]
        eps_lin = w[:, 0].reshape(shape) * eps
        for j in range(min(3, hmax)):
            eps_lin = eps_lin + w[:, j + 1].reshape(shape) * hist[:, j]
        cands["plms"] = ddim_transfer(latents, eps_lin, a_t, a_prev)
        store["plms"] = eps
    if "dpm2m" in fams:
        alpha_c, sigma_c = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
        x0 = (latents - sigma_c * eps) / alpha_c
        m2 = tables.m2[policy_id, idx].reshape(shape)
        x0_prev = hist[:, 0] if hmax >= 1 else torch.zeros_like(x0)
        d = (1.0 + m2) * x0 - m2 * x0_prev
        cands["dpm2m"] = (tables.c_lat[policy_id, idx].reshape(shape)
                          * latents
                          + tables.c_d[policy_id, idx].reshape(shape) * d)
        store["dpm2m"] = x0

    names = [f for f in SOLVERS if f in fams]
    new_lat, stored = cands[names[0]], store[names[0]]
    if len(names) > 1:
        solver = tables.solver[policy_id].reshape(shape)
        for fam in names[1:]:
            sel = solver == SOLVER_ID[fam]
            new_lat = torch.where(sel, cands[fam], new_lat)
            stored = torch.where(sel, store[fam], stored)

    if hmax > 0:
        new_hist = torch.cat([stored[:, None], hist[:, :hmax - 1]], dim=1)
    else:
        new_hist = hist
    return new_lat, new_hist
