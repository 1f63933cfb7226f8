"""Diffusion engine (port of ``repro.diffusion.engine``: one-shot
``generate`` and the slot runtime).

``generate``: encode -> the fused-CFG denoising loop
(``sampler.sample_scan``, or ``sampler.sample_scan_reuse`` from an
all-invalid cache when ``cfg.unet.reuse_policy`` is enabled) -> decode,
with the stats trajectory stacked along a leading ``num_steps`` axis.  A
``SamplerPolicy`` (and a bank holding it) swaps the solver and budget.

The slot runtime (continuous batching, DESIGN.md §8 and §10):
``init_slots`` builds an S-row ``SlotState``; ``admit`` puts a request in
a free row between steps; ``slot_step`` advances every active row by ONE
iteration, each at its own step (and, under a bank, its own policy), and
scatters the rows' integer counters into the state's ``LedgerAccum``;
``finished_slots`` / ``decode_slots`` / ``retire`` take finished rows out.
Under an enabled temporal ``reuse_policy`` the state carries a per-slot
``ReuseCache``: ``admit`` invalidates the row, so a request's first step
computes every patch, and ``slot_step`` folds the rows' reuse counters
into the accumulator.

The engine holds a ``denoiser.Denoiser`` resolved from ``cfg.unet``, so
everything above serves the UNet and the DiT family alike.  A
``core.policies.ServePolicies`` bundle (``policies=``) installs its
kernel, precision and reuse policies on the config, and its sampler and
bank become the defaults of ``generate`` and ``init_slots``.

PyTorch runs eagerly, so there is no executable cache; the wall time of a
call is taken after ``torch.cuda.synchronize()`` on the card.

Data-parallel mesh mode (DESIGN.md §6): pass ``mesh`` (a ``DeviceMesh``
with a ``data`` axis from ``launch.mesh``; one rank a card, or a gloo CPU
rank) and every rank holds the rank-0 parameters (``place_on_mesh``
broadcasts them) and runs the contiguous rows of the batch that
``NamedSharding(P("data"))`` gives its data index.  The three reductions
over the batch that the JAX package's sharded program makes global are
made over the data group: the DBSC FFN's INT12 amax and the PSSA counters
(int64, before the byte stats) in each step (``launch.mesh.use_mesh``),
the TIPS counts from the gathered masks at the end.  ``generate``
returns the global ``EngineOutput`` on every rank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.core import tips as tips_mod
from repro_torch.core.policies import ServePolicies
from repro_torch.diffusion import solvers as solvers_mod
from repro_torch.diffusion.pipeline import (PipelineConfig,
                                            _default_generator, init_params)
from repro_torch.core.reuse import ReuseCache, reuse_cache_zeros
from repro_torch.diffusion.denoiser import make_denoiser
from repro_torch.diffusion.sampler import (denoise_step, sample_scan,
                                           sample_scan_reuse)
from repro_torch.diffusion.stats import LedgerAccum, attn_layer_order
from repro_torch.diffusion.text_encoder import encode_text
from repro_torch.diffusion.vae import decode
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.tree import leaves as _leaves


@dataclasses.dataclass
class EngineOutput:
    """One engine call: images plus the stacked stats trajectory."""
    images: torch.Tensor         # (B, 8S, 8S, 3) in [-1, 1]
    latents: torch.Tensor        # (B, S, S, 4) final denoised latents
    stats: object                # UNetStats, leaves (num_steps, ...)


@dataclasses.dataclass(frozen=True)
class SlotState:
    """The in-flight batch of the slot runtime, one row per slot.

    ``step_idx`` is the next iteration each row runs; ``active`` marks the
    occupied rows (the others still run through the fixed-shape UNet call,
    their results discarded and their counters masked).  ``accum`` holds
    the integer ledger buckets.  ``uncond_context`` is None when the
    config disables CFG; ``reuse_cache`` is None unless the config's
    ``reuse_policy`` is enabled.  Under a sampler ``bank``, ``policy_id``
    selects each row's policy and ``solver_hist`` (S, H, s, s, C) carries
    the multistep history; the buckets are then per (policy, step).  The
    state is functional: every method returns a new one.
    """
    latents: torch.Tensor                     # (S, s, s, C)
    context: torch.Tensor                     # (S, Tk, d) encoded cond text
    uncond_context: Optional[torch.Tensor]    # (S, Tk, d) or None
    step_idx: torch.Tensor                    # (S,) int64
    active: torch.Tensor                      # (S,) bool
    accum: LedgerAccum
    reuse_cache: Optional[ReuseCache] = None  # per-slot temporal reuse
    policy_id: Optional[torch.Tensor] = None  # (S,) int64 under a bank
    solver_hist: Optional[torch.Tensor] = None
    bank: Optional[tuple] = None

    @property
    def num_slots(self) -> int:
        return int(self.step_idx.shape[0])


def _set_row(x: torch.Tensor, row: int, value) -> torch.Tensor:
    out = x.clone()
    out[row] = value
    return out


def _gather_rows(mesh, x: torch.Tensor, b: int, accounted: list):
    """A stacked per-row leaf (steps, rows, ...) of each rank, rows padded
    to ``b``, gathered and cut to the rows each rank accounted: the global
    leaf, rows in batch order."""
    pad = torch.zeros((x.shape[0], b - x.shape[1]) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    parts = mesh_mod.all_gather_rows(
        mesh, torch.cat([x, pad], dim=1), dim=1).split(b, dim=1)
    return torch.cat([p[:, :n] for p, n in zip(parts, accounted)], dim=1)


def _gather_stats(mesh, stats, b: int, accounted: list):
    """The global batch's stacked ``UNetStats`` from each rank's: the
    PSSA stats are global already (their counters were summed over the
    data group in each step); the per-row leaves (TIPS masks and CAS,
    reuse counters) are gathered, and each step's TIPS ratio is formed
    from the gathered mask's count and size."""
    def rows(x):
        return _gather_rows(mesh, x, b, accounted)

    def spotted(t):
        imp = rows(t.important)                 # (steps, rows, Tq)
        return t._replace(
            important=imp, cas=rows(t.cas),
            low_precision_ratio=tips_mod.low_precision_ratio(
                imp.flatten(1).sum(1, dtype=torch.int64), imp[0].numel()))
    return dataclasses.replace(
        stats, tips=tuple(spotted(t) for t in stats.tips),
        reuse=tuple(type(r)(*(rows(x) for x in r)) for r in stats.reuse))


def _check_cfg_inputs(guidance_scale: float, uncond_tokens) -> bool:
    """CFG contract: ``uncond_tokens`` iff ``guidance_scale != 1.0``."""
    wants_cfg = guidance_scale != 1.0
    has_uncond = uncond_tokens is not None
    if wants_cfg and not has_uncond:
        raise ValueError(
            f"guidance_scale={guidance_scale} requires classifier-free "
            "guidance but uncond_tokens is None — pass the unconditional "
            "prompt tokens (or set ddim.guidance_scale=1.0)")
    if has_uncond and not wants_cfg:
        raise ValueError(
            "uncond_tokens were passed but ddim.guidance_scale == 1.0 "
            "disables classifier-free guidance — drop uncond_tokens or "
            "set a guidance_scale != 1.0")
    return wants_cfg


class DiffusionEngine:
    """Holds the parameters and runs the whole text-to-image path.

    ``device=None`` means the card (a host without CUDA raises);
    ``params`` (from ``pipeline.init_params`` or ``repro_torch.convert``)
    default to random ones drawn from ``generator``.  Kernel routing and
    precision are set on the config (``configs.bk_sdm.with_kernel_policy``
    / ``with_precision``) or by ``policies`` (a ``ServePolicies``), which
    replaces the config's three policies and whose sampler and bank become
    the defaults of ``generate`` and ``init_slots``.  ``mesh`` switches
    on data-parallel execution (module docstring); None keeps the
    single-device engine as it was.
    """

    def __init__(self, cfg: PipelineConfig, device=None, params=None,
                 generator=None, policies: Optional[ServePolicies] = None,
                 mesh=None):
        self._default_sampler = self._default_bank = None
        if policies is not None:
            self._default_sampler = policies.sampler
            self._default_bank = policies.bank
            cfg = policies.apply(cfg)
        reuse = cfg.unet.reuse_policy
        if reuse.enabled and reuse.capacity < 1.0:
            # the engine's run starts from an INVALID cache: every patch is
            # active on step 0, so a gather narrower than the grid would
            # reuse zeros.  capacity < 1 belongs to the edit path
            # (sampler.sample_scan_reuse with recorded base_caches).
            raise ValueError(
                f"reuse_policy.capacity={reuse.capacity} < 1.0 on the "
                f"engine's temporal path — the cache starts invalid, so "
                f"capacity must be 1.0 (use the edit-mode sampler with "
                f"recorded base caches for shrunken gathers)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.denoiser = make_denoiser(cfg.unet)
        if params is None:
            params = init_params(cfg, generator or _default_generator(
                self.device), self.device)
        self.text_params = params["text"]
        self.unet_params = params["unet"]
        self.vae_params = params["vae"]
        self.last_wall_s: Optional[float] = None
        self.mesh = None
        self.dp_size = 1
        if mesh is not None:
            self.place_on_mesh(mesh)

    def place_on_mesh(self, mesh) -> "DiffusionEngine":
        """Replicate the parameters over ``mesh``: every rank of a data
        group takes its first rank's (a broadcast, in place), so replicas
        cannot drift.  Raises unless the mesh lies on the engine's device
        type and holds this rank."""
        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for an engine on "
                             f"{self.device}")
        mesh_mod.data_index(mesh)
        mesh_mod.broadcast_(mesh, [
            t for tree in (self.text_params, self.unet_params,
                           self.vae_params)
            for t in _leaves(tree)])
        self.mesh = mesh
        self.dp_size = mesh_mod.dp_size_of(mesh)
        return self

    @property
    def policies(self) -> ServePolicies:
        """The engine's bundle: the live config's policies (so a
        ``set_precision`` shows) with the engine's sampling defaults."""
        return ServePolicies.from_config(self.cfg.unet,
                                         sampler=self._default_sampler,
                                         bank=self._default_bank)

    def set_precision(self, policy) -> "DiffusionEngine":
        """Switch the TIPS/DBSC precision runtime on a live engine (the
        parameters do not depend on it)."""
        self.cfg = dataclasses.replace(
            self.cfg, unet=dataclasses.replace(self.cfg.unet,
                                               precision=policy))
        self.denoiser = make_denoiser(self.cfg.unet)
        return self

    def _encode(self, tokens) -> torch.Tensor:
        """(B, text_len) tokens -> (B, text_len, d) context, one row at a
        time: the card's GEMMs are picked by their row count, so a prompt
        encoded beside others can get other bits than alone, and a request
        must get the same context from ``generate`` as from ``admit``."""
        tokens = torch.as_tensor(tokens, device=self.device)
        return torch.cat([encode_text(self.text_params, tokens[i:i + 1],
                                      self.cfg.text)
                          for i in range(tokens.shape[0])])

    def _unet_apply(self, lat, tvec, ctx, active, **kw):
        return self.denoiser.apply(self.unet_params, lat, tvec, ctx,
                                   tips_active=active, **kw)

    def init_latents(self, batch: int, generator=None) -> torch.Tensor:
        s = self.cfg.unet.latent_size
        return torch.randn((batch, s, s, self.cfg.unet.in_channels),
                           generator=generator, device=self.device)

    @torch.no_grad()
    def generate(self, prompt_tokens, generator=None, uncond_tokens=None,
                 latents=None, stats_rows=None, sampler_policy=None,
                 sampler_bank=None) -> EngineOutput:
        """(B, text_len) tokens -> EngineOutput.

        ``latents`` (drawn from ``generator`` unless given) start the loop;
        ``stats_rows`` restricts the PSSA/TIPS accounting to the first N
        rows.  Wall seconds of the call land in ``self.last_wall_s``.

        ``sampler_policy`` (a ``solvers.SamplerPolicy``) swaps the solver
        and step budget; the stats then carry ``policy.num_steps`` steps.
        ``sampler_bank`` (a bank holding the policy) runs every row under
        the full bank pinned to the policy's index: the one-shot oracle of
        a slot row served under that bank (DESIGN.md §10).  With neither
        given, the engine's ``policies`` sampler (and bank) apply.
        """
        cfg = self.cfg
        if (sampler_policy is None and sampler_bank is None
                and self._default_sampler is not None):
            # a bank without a sampler only feeds init_slots: one-shot
            # generate needs a concrete policy
            sampler_policy = self._default_sampler
            sampler_bank = self._default_bank
        if sampler_bank is not None:
            sampler_bank = solvers_mod.as_bank(sampler_bank)
            if sampler_policy not in sampler_bank:
                raise ValueError(
                    f"sampler_policy {sampler_policy and sampler_policy.key()}"
                    f" is not an entry of sampler_bank "
                    f"{[p.key() for p in sampler_bank]}")
        use_cfg = _check_cfg_inputs(cfg.ddim.guidance_scale, uncond_tokens)
        prompt_tokens = torch.as_tensor(prompt_tokens, device=self.device)
        batch = prompt_tokens.shape[0]
        if self.mesh is not None:
            if batch % self.dp_size:
                raise ValueError(
                    f"batch {batch} must be a multiple of the data-parallel "
                    f"degree {self.dp_size} under mesh "
                    f"{mesh_mod.mesh_shape(self.mesh)} — pad the "
                    f"micro-batch")
            if stats_rows is not None and not 0 < stats_rows <= batch:
                raise ValueError(f"stats_rows={stats_rows} outside "
                                 f"[1, {batch}]")
        if latents is None:
            latents = self.init_latents(batch, generator)
        latents = torch.as_tensor(latents, dtype=torch.float32,
                                  device=self.device)
        t0 = time.perf_counter()
        if self.mesh is None:
            return self._run(prompt_tokens, uncond_tokens, latents,
                             stats_rows, sampler_policy, sampler_bank,
                             use_cfg, t0)
        with mesh_mod.use_mesh(self.mesh):
            return self._generate_rows(prompt_tokens, uncond_tokens,
                                       latents, stats_rows, sampler_policy,
                                       sampler_bank, use_cfg, t0)

    def _generate_rows(self, prompt_tokens, uncond_tokens, latents,
                       stats_rows, sampler_policy, sampler_bank, use_cfg,
                       t0) -> EngineOutput:
        """Mesh mode: run this rank's rows, return the global output."""
        b = prompt_tokens.shape[0] // self.dp_size
        lo = mesh_mod.data_index(self.mesh) * b
        rows = slice(lo, lo + b)
        local_rows = (None if stats_rows is None
                      else min(max(stats_rows - lo, 0), b))
        out = self._run(prompt_tokens[rows],
                        None if uncond_tokens is None
                        else torch.as_tensor(uncond_tokens)[rows],
                        latents[rows], local_rows, sampler_policy,
                        sampler_bank, use_cfg, t0)
        accounted = [b if stats_rows is None
                     else min(max(stats_rows - i * b, 0), b)
                     for i in range(self.dp_size)]
        gathered = EngineOutput(
            images=mesh_mod.all_gather_rows(self.mesh, out.images),
            latents=mesh_mod.all_gather_rows(self.mesh, out.latents),
            stats=_gather_stats(self.mesh, out.stats, b, accounted))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_wall_s = time.perf_counter() - t0
        return gathered

    def _run(self, prompt_tokens, uncond_tokens, latents, stats_rows,
             sampler_policy, sampler_bank, use_cfg, t0) -> EngineOutput:
        """encode -> denoising loop -> decode on this process's rows."""
        cfg = self.cfg
        context = self._encode(prompt_tokens)
        uncond = self._encode(uncond_tokens) if use_cfg else None
        if cfg.unet.reuse_policy.enabled:
            cache = reuse_cache_zeros(cfg.unet, latents.shape[0],
                                      use_cfg=use_cfg, device=self.device)
            latents, stats = sample_scan_reuse(
                self._unet_apply, latents, context, uncond, cfg.ddim,
                reuse_cache=cache, stats_rows=stats_rows,
                sampler_policy=sampler_policy, sampler_bank=sampler_bank)
        else:
            latents, stats = sample_scan(self._unet_apply, latents, context,
                                         uncond, cfg.ddim,
                                         stats_rows=stats_rows,
                                         sampler_policy=sampler_policy,
                                         sampler_bank=sampler_bank)
        images = decode(self.vae_params, latents, cfg.vae)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_wall_s = time.perf_counter() - t0
        return EngineOutput(images=images, latents=latents, stats=stats)

    def warmup(self, batch: int, use_cfg: Optional[bool] = None,
               stats_rows: Optional[int] = None, sampler_policy=None,
               sampler_bank=None) -> float:
        """Run (and discard) one call of the given shape: the card's
        lazily built kernels and cuDNN plans are made off the clock.

        ``use_cfg`` defaults to what the config demands; forcing it
        against the config raises as ``generate`` does.  Returns the wall
        seconds of the call.
        """
        cfg = self.cfg
        if use_cfg is None:
            use_cfg = cfg.ddim.guidance_scale != 1.0
        toks = torch.zeros((batch, cfg.text.max_len), dtype=torch.int32,
                           device=self.device)
        t0 = time.perf_counter()
        self.generate(toks, uncond_tokens=toks.clone() if use_cfg else None,
                      generator=torch.Generator(
                          device=self.device).manual_seed(0),
                      stats_rows=stats_rows, sampler_policy=sampler_policy,
                      sampler_bank=sampler_bank)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    # Slot-state mode: continuous batching (DESIGN.md §8)
    # ------------------------------------------------------------------
    def init_slots(self, num_slots: int, bank=None) -> SlotState:
        """Fresh all-inactive slot state of ``num_slots`` rows.

        ``bank`` (a tuple of ``solvers.SamplerPolicy``) lets requests of
        different policies share one ``slot_step``: each row's policy is
        its ``policy_index`` at admission, the multistep history rides the
        state, and the ledger buckets are per (policy, step) -- bucket
        ``p * N + i`` (N = the bank's largest budget) holds policy ``p``'s
        step-``i`` counters (``pipeline.energy_report_banked``).  Under
        an enabled ``reuse_policy`` the state carries an all-invalid
        per-slot reuse cache.  ``bank=None`` takes the engine's
        ``policies`` bank.
        """
        if self.mesh is not None:
            raise ValueError(
                "slot-state mode is single-device: per-slot admission "
                "rewrites batch rows between steps (use micro-batch "
                "serving for mesh execution)")
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots} must be >= 1")
        if bank is None:
            bank = self._default_bank
        cfg = self.cfg
        s, c = cfg.unet.latent_size, cfg.unet.in_channels
        ctx_shape = (num_slots, cfg.text.max_len, cfg.text.d_model)
        use_cfg = cfg.ddim.guidance_scale != 1.0
        dev = self.device
        if bank is not None:
            bank = solvers_mod.as_bank(bank)
        num_buckets = (cfg.ddim.num_inference_steps if bank is None
                       else len(bank) * solvers_mod.bank_max_steps(bank))
        return SlotState(
            latents=torch.zeros((num_slots, s, s, c), device=dev),
            context=torch.zeros(ctx_shape, device=dev),
            uncond_context=(torch.zeros(ctx_shape, device=dev) if use_cfg
                            else None),
            step_idx=torch.zeros((num_slots,), dtype=torch.int64,
                                 device=dev),
            active=torch.zeros((num_slots,), dtype=torch.bool, device=dev),
            accum=LedgerAccum.zeros(num_buckets,
                                    len(attn_layer_order(cfg.unet)), dev),
            reuse_cache=(reuse_cache_zeros(cfg.unet, num_slots, use_cfg,
                                           device=dev)
                         if cfg.unet.reuse_policy.enabled else None),
            policy_id=(torch.zeros((num_slots,), dtype=torch.int64,
                                   device=dev) if bank is not None else None),
            solver_hist=(solvers_mod.init_history(bank, num_slots, (s, s, c),
                                                  dev)
                         if bank is not None else None),
            bank=bank)

    @torch.no_grad()
    def admit(self, state: SlotState, slot: int, prompt_tokens,
              generator=None, uncond_tokens=None, latents=None,
              policy_index: int = 0) -> SlotState:
        """Put a new request in row ``slot`` (between steps).

        ``prompt_tokens`` is (1, text_len); the initial latent row is drawn
        from ``generator`` unless ``latents`` (1, s, s, C) is given.  The
        CFG contract of ``generate`` applies, and the state must have been
        built for the same CFG mode.  ``policy_index`` picks the request's
        policy from the state's bank; admission zeroes the row's solver
        history, so a multistep solver starts as a fresh one-shot run,
        and invalidates the row's reuse cache, so its first step reuses
        nothing of the previous occupant's.
        """
        use_cfg = _check_cfg_inputs(self.cfg.ddim.guidance_scale,
                                    uncond_tokens)
        if use_cfg != (state.uncond_context is not None):
            raise ValueError(
                "slot state CFG mode does not match the admit call — "
                "rebuild the state with init_slots() for this config")
        if state.bank is None:
            if policy_index != 0:
                raise ValueError(
                    f"policy_index={policy_index} on a bank-less slot "
                    f"state — build the state with init_slots(bank=...)")
        elif not 0 <= policy_index < len(state.bank):
            raise ValueError(
                f"policy_index={policy_index} outside the state's bank "
                f"of {len(state.bank)} policies")
        if not 0 <= slot < state.num_slots:
            raise ValueError(f"slot={slot} outside [0, {state.num_slots})")
        ctx = self._encode(prompt_tokens)
        if latents is None:
            latents = self.init_latents(1, generator)
        lat = torch.as_tensor(latents, dtype=torch.float32,
                              device=self.device)
        new = dataclasses.replace(
            state,
            latents=_set_row(state.latents, slot, lat[0]),
            context=_set_row(state.context, slot, ctx[0]),
            step_idx=_set_row(state.step_idx, slot, 0),
            active=_set_row(state.active, slot, True))
        if use_cfg:
            un = self._encode(uncond_tokens)
            new = dataclasses.replace(
                new, uncond_context=_set_row(state.uncond_context, slot,
                                             un[0]))
        if state.reuse_cache is not None:
            new = dataclasses.replace(
                new, reuse_cache=state.reuse_cache.invalidate_row(slot))
        if state.bank is not None:
            new = dataclasses.replace(
                new, policy_id=_set_row(state.policy_id, slot, policy_index),
                solver_hist=_set_row(state.solver_hist, slot, 0.0))
        return new

    @torch.no_grad()
    def slot_step(self, state: SlotState) -> SlotState:
        """Advance every active row by ONE denoising iteration.

        The rows' per-row counters go into ``state.accum``: bucket
        ``step`` (or ``policy * N + step`` under a bank), masked by
        ``active`` before the add.  A banked row at or past its budget
        (a finished slot not yet retired) maps out of range and is
        dropped, so it can never bleed into the next policy's buckets.
        Under temporal reuse the state's cache is threaded through the
        step and the rows' reuse counters land in the same buckets.
        Wall seconds land in ``self.last_wall_s``.
        """
        cfg = self.cfg
        t0 = time.perf_counter()
        if state.bank is not None:
            lat, stats, cache, hist = denoise_step(
                self._unet_apply, state.latents, state.context,
                state.uncond_context, state.step_idx, cfg.ddim,
                active=state.active, row_stats=True,
                reuse_cache=state.reuse_cache, bank=state.bank,
                policy_id=state.policy_id, solver_hist=state.solver_hist)
            n_max = solvers_mod.bank_max_steps(state.bank)
            budgets = solvers_mod.solver_tables(
                state.bank, cfg.ddim, self.device).budget[state.policy_id]
            bucket = torch.where(state.step_idx < budgets,
                                 state.policy_id * n_max + state.step_idx,
                                 len(state.bank) * n_max)
        else:
            out = denoise_step(
                self._unet_apply, state.latents, state.context,
                state.uncond_context, state.step_idx, cfg.ddim,
                active=state.active, row_stats=True,
                reuse_cache=state.reuse_cache)
            lat, stats = out[:2]
            cache = out[2] if state.reuse_cache is not None else None
            hist, bucket = None, state.step_idx
        new = dataclasses.replace(
            state, latents=lat, solver_hist=hist, reuse_cache=cache,
            accum=state.accum.scatter(bucket, state.active, stats),
            step_idx=state.step_idx + state.active.to(torch.int64))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_wall_s = time.perf_counter() - t0
        return new

    def finished_slots(self, state: SlotState) -> list:
        """Active rows whose step counter has run off THEIR schedule (a
        banked row against its own policy's budget)."""
        idx = state.step_idx.tolist()
        act = state.active.tolist()
        if state.bank is not None:
            budgets = [state.bank[p].num_steps
                       for p in state.policy_id.tolist()]
        else:
            budgets = [self.cfg.ddim.num_inference_steps] * len(idx)
        return [i for i in range(len(idx)) if act[i] and idx[i] >= budgets[i]]

    @torch.no_grad()
    def decode_slots(self, state: SlotState, slots=None) -> torch.Tensor:
        """VAE-decode slot latents: the whole buffer in one batch-S call
        (``slots=None``), or the named rows in power-of-two chunks (a
        retirement usually frees one or two rows; chunking bounds the
        decode shapes to log2(S) + 1)."""
        if slots is None:
            return decode(self.vae_params, state.latents, self.cfg.vae)
        slots = list(slots)
        if not slots:
            raise ValueError(
                "decode_slots: empty slot list — guard on "
                "finished_slots() (or pass slots=None for the whole "
                "buffer)")
        out, i = [], 0
        while i < len(slots):
            c = 1 << ((len(slots) - i).bit_length() - 1)
            sel = torch.tensor(slots[i:i + c], device=self.device)
            out.append(decode(self.vae_params, state.latents[sel],
                              self.cfg.vae))
            i += c
        return out[0] if len(out) == 1 else torch.cat(out, dim=0)

    def decode_preview(self, state: SlotState, slots) -> torch.Tensor:
        """Decode IN-FLIGHT rows at whatever step each has reached, through
        the same chunked decode as ``decode_slots`` (a preview of a row
        that just finished equals its final image)."""
        return self.decode_slots(state, list(slots))

    def retire(self, state: SlotState, slots) -> SlotState:
        """Free finished rows (after decoding); they become admissible."""
        active = state.active.clone()
        active[torch.tensor(list(slots), dtype=torch.int64,
                            device=self.device)] = False
        return dataclasses.replace(state, active=active)
