"""Concentration-prescription shared by the gas-chemistry components.

MAGICC7's ``SWITCHFROMCONC2EMIS_YEAR`` handling (module_01/module_02 docs
§7.2): while ``t_next <= until`` the output written at step N+1 comes
verbatim from the prescribed series (aligned to the model time axis);
afterwards the emissions-driven update takes over seamlessly from the
last prescribed value: a host gather and a select per step.  One
implementation serves CH4 and N2O so the switch-year
epsilon, the step_index+1 alignment and the dtype handling cannot drift
apart.
"""

from __future__ import annotations

import numpy as np

from rscm_tpu_torch.core import xmath as xm


def apply_prescribed_concentration(ctx, computed, series, until):
    """Select the prescribed value while ``ctx.t_next`` <= ``until``.

    ``series``/``until`` of ``None`` disable prescription (the computed
    value passes through untouched).
    """
    if series is None or until is None:
        return computed
    series = np.asarray(series, dtype=np.float64)
    idx_next = xm.clip(ctx.step_index + 1, 0, len(series) - 1)
    prescribed = xm.take(series, idx_next)
    use_prescribed = ctx.t_next <= float(until) + 1e-9
    return xm.where(use_prescribed, prescribed, computed)
