"""The device population as (N,) tensors on one device.

``FleetState`` is a NamedTuple of per-device vectors; every update below
is O(N) elementwise torch plus one stable sort in selection, on the
fleet's device, with no host round-trip — no ``.item()``, ``float()`` or
``.cpu()`` — so a 10^6-device fleet advances while the host queues the
next round.

The channel composes the paper's quasi-static Rayleigh blocks with a
static per-device **pathloss class** (``FleetConfig.pathloss_classes``)
and **temporal correlation**: the complex fading state evolves by the
Gauss-Markov AR(1) step (``channel.gauss_markov_fading_step``), so a
device in a deep fade stays faded for ~1/(1-ρ) rounds.  Batteries are
debited by the §II-D energy model at each device's assigned power
(``population.power``), with the radio capped at the round deadline; a
device that cannot pay the round is ineligible until harvesting
(``FleetConfig.harvest_j_per_round``) refills it.

Randomness comes from a ``torch.Generator`` or, all of it, from
:class:`RoundDraws` (and :class:`FleetInitDraws` at init), so a test can
inject the reference's own draws; the port does not reproduce threefry.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.config.base import SELECTION_POLICIES, Config
from repro_torch.core import channel as ch
from repro_torch.core import energy as energy_mod
from repro_torch.device import DeviceLike, make_generator, resolve_device
from repro_torch.obs.trace import phase_span
from repro_torch.population import power as ppower

GenLike = Union[int, torch.Generator]


class FleetState(NamedTuple):
    """Per-device population state carried across rounds: (N,) float32
    vectors and the 0-dim int32 round-robin cursor, all on one device."""
    h_re: torch.Tensor        # complex fading state, real part
    h_im: torch.Tensor        # complex fading state, imaginary part
    pathloss: torch.Tensor    # static mean-|h|² multiplier (class gain)
    battery_j: torch.Tensor   # remaining battery energy (J)
    capacity_j: torch.Tensor  # battery capacity (J): the initial draw,
                              # where the harvesting credit caps
    harvest_scale: torch.Tensor  # per-device harvest multiplier (by class)
    p_last: torch.Tensor      # last assigned per-device tx power (W)
    available: torch.Tensor   # current-round availability {0., 1.}
    rr_cursor: torch.Tensor   # () int32 — round_robin scan pointer

    @property
    def size(self) -> int:
        return self.battery_j.shape[0]

    def gain2(self) -> torch.Tensor:
        """Current channel power gain |h|² (pathloss folded into h)."""
        return self.h_re * self.h_re + self.h_im * self.h_im


class FleetInitDraws(NamedTuple):
    """The draws of :func:`init_fleet`: class indices (N,) int64, the
    fading state's standard normals (N,) twice, battery uniforms (N,)."""
    cls_idx: torch.Tensor
    z_re: torch.Tensor
    z_im: torch.Tensor
    u_battery: torch.Tensor


class RoundDraws(NamedTuple):
    """The draws of one :func:`round_update`: the fading innovations'
    standard normals (N,) twice, availability uniforms (N,), the
    ``uniform`` selection policy's scores (N,) (None under the other
    policies, which draw nothing), and the drop uniforms (k,)."""
    z_re: torch.Tensor
    z_im: torch.Tensor
    u_avail: torch.Tensor
    u_select: Optional[torch.Tensor]
    u_drop: torch.Tensor


def init_fleet(gen: GenLike, config: Config, *, device: DeviceLike = None,
               draws: Optional[FleetInitDraws] = None) -> FleetState:
    """Draw the initial fleet from ``config.fleet`` on ``device`` (None: the
    CUDA device).

    Pathloss classes are sampled from ``class_probs`` (uniform when empty),
    the fading state starts at its stationary distribution
    CN(0, rayleigh_scale·pathloss), and batteries spread uniformly over
    ``battery_j·(1 ± battery_spread)``.  Everybody starts available.
    """
    fcfg = config.fleet
    if not fcfg.enabled:
        raise ValueError("init_fleet needs fleet.size > 0")
    if fcfg.selection not in SELECTION_POLICIES:
        raise ValueError(f"unknown fleet.selection {fcfg.selection!r}")
    ppower.validate_config(config.power)
    if (fcfg.harvest_class_scale
            and len(fcfg.harvest_class_scale) != len(fcfg.pathloss_classes)):
        raise ValueError("harvest_class_scale must match pathloss_classes "
                         "length")
    dev = resolve_device(device)
    n = int(fcfg.size)
    if draws is None:
        g = make_generator(gen, dev)
        n_cls = len(fcfg.pathloss_classes)
        if fcfg.class_probs:
            probs = torch.tensor(fcfg.class_probs, dtype=torch.float32,
                                 device=dev)
            cls_idx = torch.multinomial(probs, n, replacement=True,
                                        generator=g)
        else:
            cls_idx = torch.randint(0, n_cls, (n,), generator=g, device=dev)
        z_re = torch.randn(n, generator=g, device=dev)
        z_im = torch.randn(n, generator=g, device=dev)
        u_battery = torch.rand(n, generator=g, device=dev)
        draws = FleetInitDraws(cls_idx, z_re, z_im, u_battery)
    classes = torch.tensor(fcfg.pathloss_classes, dtype=torch.float32,
                           device=dev)
    pathloss = classes[draws.cls_idx]
    if fcfg.harvest_class_scale:
        harvest_scale = torch.tensor(fcfg.harvest_class_scale,
                                     dtype=torch.float32,
                                     device=dev)[draws.cls_idx]
    else:
        harvest_scale = torch.ones(n, dtype=torch.float32, device=dev)
    scale = config.channel.rayleigh_scale * pathloss
    h_re, h_im = ch.init_rayleigh_state(None, (n,), scale,
                                        normals=(draws.z_re, draws.z_im))
    spread = fcfg.battery_spread
    battery = (fcfg.battery_j * (1.0 + spread * (2.0 * draws.u_battery - 1.0))
               ).float()
    return FleetState(h_re=h_re, h_im=h_im, pathloss=pathloss,
                      battery_j=battery, capacity_j=battery,
                      harvest_scale=harvest_scale,
                      p_last=torch.zeros(n, dtype=torch.float32, device=dev),
                      available=torch.ones(n, dtype=torch.float32, device=dev),
                      rr_cursor=torch.zeros((), dtype=torch.int32, device=dev))


class _LegacyFleetState(NamedTuple):
    """``FleetState``'s layout before the power-control fields
    (capacity_j, harvest_scale, p_last): older fleet checkpoints hold its
    6 leaves in this field order."""
    h_re: torch.Tensor
    h_im: torch.Tensor
    pathloss: torch.Tensor
    battery_j: torch.Tensor
    available: torch.Tensor
    rr_cursor: torch.Tensor


def restore_fleet_checkpoint(directory: str, template: FleetState,
                             step: Optional[int] = None) -> FleetState:
    """Restore a checkpointed ``FleetState`` onto the template's devices,
    migrating a legacy 6-leaf state as the reference does: capacity is the
    restored battery (harvesting can then never fill past the resume
    point), the harvest scale 1 and ``p_last`` 0 (assigned afresh by the
    next round).  A current checkpoint restores every field."""
    from repro_torch.checkpoint import restore_checkpoint

    try:
        return restore_checkpoint(directory, template, step)
    except ValueError:
        legacy = restore_checkpoint(
            directory,
            _LegacyFleetState(**{f: getattr(template, f)
                                 for f in _LegacyFleetState._fields}),
            step)
        return template._replace(
            **legacy._asdict(), capacity_j=legacy.battery_j.clone(),
            harvest_scale=torch.ones_like(legacy.battery_j),
            p_last=torch.zeros_like(legacy.battery_j))


def advance_channel(state: FleetState, gen: Optional[torch.Generator],
                    config: Config, *, normals=None,
                    u_avail: Optional[torch.Tensor] = None) -> FleetState:
    """One round of channel and availability evolution for the whole
    fleet: an AR(1) step at each device's pathloss-scaled stationary power
    and a fresh availability draw (uniform < ``availability``)."""
    scale = config.channel.rayleigh_scale * state.pathloss
    h_re, h_im = ch.gauss_markov_fading_step(
        gen, state.h_re, state.h_im, config.fleet.fading_rho, scale,
        normals=normals)
    if u_avail is None:
        u_avail = torch.rand(state.available.shape, generator=gen,
                             device=state.available.device)
    available = (u_avail < config.fleet.availability).float()
    return state._replace(h_re=h_re, h_im=h_im, available=available)


def fleet_rates(state: FleetState, ch_cfg,
                tx_power_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-device achieved FBL rate (bits/s/Hz) at the current fading and
    the policy's per-device power (None: the config's P_tx scalar, read
    through ``power.fixed_power_w``)."""
    if tx_power_w is None:
        tx_power_w = ppower.fixed_power_w(None, ch_cfg)
    return ch.fbl_rate(ch.snr(tx_power_w, state.gain2(), ch_cfg.noise_w),
                       ch_cfg.blocklength, ch_cfg.error_prob)


def round_cost_j(config: Config, rates: torch.Tensor, num_params: int,
                 tx_power_w: Optional[torch.Tensor] = None,
                 wire_bits_per_param: Optional[float] = None) -> torch.Tensor:
    """Per-device energy of one round (N,): local training (eq. 7) plus
    the uplink at each device's rate and assigned power (eq. 9), the radio
    cut off at ``tau_limit_s``.  Both runtimes price the ideal d·n payload
    (``wire_bits_per_param`` None): a wire-priced debit would fork the
    battery trajectory, and through it the selection and the model,
    across wire formats."""
    qcfg = config.quant
    e_l = energy_mod.local_training_energy_j(
        config.energy, num_params, qcfg.bits if qcfg.enabled else 32,
        config.fl.local_iters)
    e_u = energy_mod.capped_uplink_energy_j(
        config.channel, num_params, ppower.uplink_bits(config), rates,
        config.fl.tau_limit_s, tx_power_w=tx_power_w,
        wire_bits_per_param=wire_bits_per_param)
    return (e_l + e_u).float()


def round_latency_s(config: Config, rates: torch.Tensor, num_params: int,
                    macs_per_iter: float) -> torch.Tensor:
    """Per-device realized round latency τ_u + τ_comp, the radio capped at
    the deadline."""
    tau_u = torch.clamp(
        energy_mod.uplink_time_s(config.channel, num_params,
                                 ppower.uplink_bits(config), rates),
        max=config.fl.tau_limit_s)
    tau_c = energy_mod.compute_time_s(config.energy, macs_per_iter,
                                      config.fl.local_iters)
    return tau_u + tau_c


def debit_battery(state: FleetState, device_idx: torch.Tensor,
                  cost_j: torch.Tensor) -> Tuple[FleetState, torch.Tensor]:
    """Charge the selected devices their round cost, clipped at empty.
    Returns ``(new_state, realized_charge_j)``."""
    battery, charge = energy_mod.battery_debit_j(state.battery_j,
                                                 device_idx, cost_j)
    return state._replace(battery_j=battery), charge


def credit_harvest(state: FleetState,
                   config: Config) -> Tuple[FleetState, torch.Tensor]:
    """Credit this round's harvest, capped at each device's capacity.
    Returns ``(new_state, realized_credit_total_j)``: the fleet's energy
    rises by exactly the credit."""
    h = config.fleet.harvest_j_per_round
    if h <= 0:
        return state, torch.zeros((), dtype=torch.float32,
                                  device=state.battery_j.device)
    credit = torch.minimum(state.capacity_j - state.battery_j,
                           h * state.harvest_scale)
    credit = torch.clamp(credit, min=0.0)
    return state._replace(battery_j=state.battery_j + credit), credit.sum()


def advance_cursor(state: FleetState, k: int) -> FleetState:
    """Move the round_robin pointer past the ``k`` slots just scanned."""
    return state._replace(rr_cursor=torch.remainder(state.rr_cursor + k,
                                                    state.size))


class FleetRoundInfo(NamedTuple):
    """What one round of fleet evolution decided: cohort-shaped (k,)
    tensors and the 0-dim fleet-wide harvest."""
    idx: torch.Tensor        # selected device ids (int64)
    valid: torch.Tensor      # filled-slot mask
    lam: torch.Tensor        # realized packet successes (valid-masked)
    rates_sel: torch.Tensor  # selected devices' achieved FBL rates
    cost_sel: torch.Tensor   # selected devices' round energy cost (J)
    power_sel: torch.Tensor  # selected devices' assigned tx power (W)
    outage_sel: torch.Tensor  # valid slots whose rate misses the deadline
                              # threshold (power.min_rate): drop w.p. 1
    charge_j: torch.Tensor   # realized battery debit per slot
    harvest_j: torch.Tensor  # () realized fleet-wide harvest credit (J)
    scores: torch.Tensor     # (N,) masked scores the cohort was ranked by


def draw_round(gen: torch.Generator, config: Config, n: int,
               k: int) -> RoundDraws:
    """The draws of one round from ``gen``, in :class:`RoundDraws` order."""
    dev = gen.device
    z_re = torch.randn(n, generator=gen, device=dev)
    z_im = torch.randn(n, generator=gen, device=dev)
    u_avail = torch.rand(n, generator=gen, device=dev)
    u_select = (torch.rand(n, generator=gen, device=dev)
                if config.fleet.selection == "uniform" else None)
    u_drop = torch.rand(k, generator=gen, device=dev)
    return RoundDraws(z_re, z_im, u_avail, u_select, u_drop)


def round_update(state: FleetState, gen: Optional[torch.Generator],
                 config: Config, num_params: int, k: int,
                 wire_bits_per_param: Optional[float] = None, *,
                 draws: Optional[RoundDraws] = None
                 ) -> Tuple[FleetState, FleetRoundInfo]:
    """The one per-round fleet state machine both runtimes share: advance
    the channel and availability → assign per-device power → rates →
    round cost → cohort selection → FBL-tied drops → battery debit →
    harvest credit → cursor, each phase in its ``fleet/*`` span.

    O(N) on the fleet's device with no host round-trip.  The draws come
    from ``gen`` or, all of them, from ``draws``.  The power vector and
    the debit price the wire-independent d·n payload unless
    ``wire_bits_per_param`` is given (see :func:`round_cost_j`).
    """
    from repro_torch.population import errors as perrors
    from repro_torch.population import selection as psel

    if draws is None:
        if gen is None:
            raise ValueError("pass a generator, or the draws")
        draws = draw_round(gen, config, state.size, k)
    with phase_span("fleet/advance_channel"):
        state = advance_channel(state, None, config,
                                normals=(draws.z_re, draws.z_im),
                                u_avail=draws.u_avail)
    with phase_span("fleet/power_assign"):
        power = ppower.assigned_power(config, state.gain2(), state.battery_j,
                                      state.capacity_j, num_params)
        state = state._replace(p_last=power)
    with phase_span("fleet/rates_cost"):
        rates = fleet_rates(state, config.channel, power)
        cost = round_cost_j(config, rates, num_params, tx_power_w=power,
                            wire_bits_per_param=wire_bits_per_param)
    with phase_span("fleet/select"):
        scores = psel.masked_scores(config.fleet.selection, state, rates,
                                    None, cost,
                                    lyapunov_v=config.power.lyapunov_v,
                                    u=draws.u_select)
        idx, valid = psel.cohort_from_scores(scores, k)
    rates_sel = rates[idx]
    with phase_span("fleet/drop_realize"):
        # outage: the uplink cannot finish by the deadline at the assigned
        # power — the one definition drops, IPW reach and telemetry share
        r_min = ppower.min_rate(config, num_params)
        outage_sel = valid * perrors.below(rates_sel, r_min)
        lam = valid * perrors.realize_packet_success(
            None, rates_sel, config.channel.error_prob, min_rate=r_min,
            u=draws.u_drop)
    with phase_span("fleet/energy_ledger"):
        cost_sel = cost[idx]
        state, charge = debit_battery(state, idx, valid * cost_sel)
        state, harvested = credit_harvest(state, config)
        state = advance_cursor(state, k)
    return state, FleetRoundInfo(idx=idx, valid=valid, lam=lam,
                                 rates_sel=rates_sel, cost_sel=cost_sel,
                                 power_sel=power[idx], outage_sel=outage_sel,
                                 charge_j=charge, harvest_j=harvested,
                                 scores=scores)
