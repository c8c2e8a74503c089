"""Fleet-scale device population layer (beyond-paper).

The paper simulates N=100 homogeneous devices with i.i.d. per-round fading
and uniform participation.  This package models a population as (N,)
tensors on one device, so the whole fleet update runs there with no
per-round host round-trip (10^6 devices on the card):

  fleet.py      ``FleetState``: per-device pathloss class, Gauss-Markov
                AR(1) correlated Rayleigh fading, battery energy (J)
                debited by the §II-D model, a per-round availability
                trace; ``round_update``, the one per-round state machine.
  power.py      per-device adaptive uplink power: fixed (CMA-ES-seeded) /
                channel_inversion / fbl_target / lyapunov.
  selection.py  cohort selection by a masked, stably sorted ranking:
                uniform / rate_aware / energy_aware / round_robin /
                lyapunov; dead or unavailable devices never selected.
  errors.py     packet errors tied to the FBL operating point at the
                assigned power (outage ⇒ certain drop) and the opt-in
                unbiased 1/(1-q) reweighting.
  telemetry.py  the one place round metrics are assembled.

``core.fl`` threads a ``FleetState`` through ``FLSimulator.run_rounds`` and
through the cohort round ``make_fl_round`` (every wire format runs
unchanged under any (selection, power) pair).
"""
from repro_torch.population import errors, fleet, power, selection, telemetry

__all__ = ["errors", "fleet", "power", "selection", "telemetry"]
