"""Sensitivities through the MAGICC graph: the port against the JAX package.

The ``SensitivityAnalyzer`` Jacobian ``d trajectory / d theta`` (forward
mode: the parameters' tangent directions ride as members of one run)
agrees with the JAX package's ``jax.jacfwd`` within 1e-7 of its largest
entry per variable, on the three-parameter problem (ECS, tau_OH, beta) at
1850-1860 with the flux history in the working dtype (float64).
"""

import numpy as np

from rscm_tpu.calibrate import SensitivityAnalyzer as JaxSensitivityAnalyzer
from rscm_tpu.magicc.calibration import magicc_calibration as jax_magicc_calibration
from rscm_tpu_torch.calibrate import SensitivityAnalyzer
from rscm_tpu_torch.magicc.calibration import magicc_calibration


def test_sensitivity_jacobian_matches_jacfwd():
    names = ["ecs", "tau_oh", "beta"]
    years = np.arange(1850.0, 1861.0)
    kwargs = dict(years=years, param_names=names, obs_interval=2,
                  model_kwargs={"ocean_params": {"history_dtype": "float32"}})
    port, ref = magicc_calibration(device="cpu", **kwargs), jax_magicc_calibration(**kwargs)
    theta = ref.theta_true
    got = SensitivityAnalyzer(port.runner).jacobian(theta)
    want = JaxSensitivityAnalyzer(ref.runner).jacobian(theta)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape == (len(years), got[name].shape[1], 3)
        w = np.nan_to_num(want[name])
        np.testing.assert_allclose(np.nan_to_num(got[name]), w, rtol=0.0,
                                   atol=1e-7 * np.max(np.abs(w)), err_msg=name)
