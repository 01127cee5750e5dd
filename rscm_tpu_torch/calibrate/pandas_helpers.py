"""
Pandas integration for the calibration framework.

Port of ``rscm_tpu/calibrate/pandas_helpers.py`` (host code, copied as it
is; imported only where pandas is installed).  Mirror of
``python/rscm/calibrate/pandas_helpers.py``:
``chain_to_dataframe`` (multi-index walker/iteration trace frame) and
``target_from_dataframe`` (tabular observations -> Target).
"""

from __future__ import annotations

import numpy as np

__all__ = ["chain_to_dataframe", "target_from_dataframe"]


def chain_to_dataframe(chain, discard: int = 0):
    """Chain -> DataFrame with (walker, iteration) MultiIndex + log_prob."""
    import pandas as pd

    param_names = chain.param_names
    n_stored = len(chain) - discard
    if n_stored <= 0 or chain.is_empty():
        return pd.DataFrame(columns=[*param_names, "log_prob"])

    stacked = np.asarray(chain.samples[discard:])  # (n_stored, W, D)
    log_probs = np.asarray(chain.log_probs[discard:])  # (n_stored, W)
    n_walkers = stacked.shape[1]
    n_params = len(param_names)

    # walker-major layout to match the reference's flat_samples reshape
    samples = stacked.transpose(1, 0, 2).reshape(-1, n_params)
    lp = log_probs.transpose(1, 0).reshape(-1)

    walker_idx = np.repeat(np.arange(n_walkers), n_stored)
    thin = chain.thin
    iter_idx = np.tile(
        np.arange(discard, discard + n_stored * thin, thin), n_walkers
    )

    data = {name: samples[:, i] for i, name in enumerate(param_names)}
    data["log_prob"] = lp
    return pd.DataFrame(
        data,
        index=pd.MultiIndex.from_arrays(
            [walker_idx, iter_idx], names=["walker", "iteration"]
        ),
    )


def target_from_dataframe(
    df,
    time_col: str = "time",
    value_col: str = "value",
    uncertainty_col=None,
    relative_error=None,
    variable_col: str = "variable",
    variable_name: str = None,
):
    """Build a Target from tabular observations.

    With a ``variable`` column, observations are grouped per variable;
    otherwise ``variable_name`` names the single variable.  Uncertainties
    come from ``uncertainty_col`` (default ``"uncertainty"``) or, if
    ``relative_error`` is given, as ``|value| * relative_error``.
    """
    from .target import Target

    target = Target()

    if variable_col in df.columns:
        groups = df.groupby(variable_col)
    else:
        if variable_name is None:
            raise ValueError(
                "DataFrame has no 'variable' column; pass variable_name="
            )
        groups = [(variable_name, df)]

    for name, group in groups:
        vt = target.add_variable(str(name))
        for _, row in group.iterrows():
            time = float(row[time_col])
            value = float(row[value_col])
            if relative_error is not None:
                uncertainty = abs(value) * float(relative_error)
            else:
                col = uncertainty_col or "uncertainty"
                if col not in group.columns:
                    raise ValueError(
                        f"No uncertainty column '{col}' and no relative_error given"
                    )
                uncertainty = float(row[col])
            vt.add(time, value, uncertainty)
    return target


# Attach as a method, mirroring the reference's monkey-patch
# (python/rscm/calibrate/__init__.py): chain.to_dataframe(discard=...)
def _install_chain_to_dataframe():
    from .chain import Chain

    def to_dataframe(self, discard: int = 0):
        return chain_to_dataframe(self, discard)

    Chain.to_dataframe = to_dataframe


_install_chain_to_dataframe()
