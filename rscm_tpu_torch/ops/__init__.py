"""
Hand-written CUDA kernels, each beside its plain PyTorch version, with a
launch count on the wrapper:

- :mod:`.udeb_month` — ``udeb_year``, its tangent ``udeb_year_jvp`` and its
  adjoint ``udeb_year_vjp`` (``udeb_year.launches``, ...);
- :mod:`.lamcalc_kernel` — ``lamcalc``, ``lamcalc_jvp`` and ``lamcalc_vjp``
  (``lamcalc.launches``, ...);
- :mod:`.plain_grad` — ``plain_jvp``, the plain versions' forward-mode
  derivative, for the CPU and for the checks on the card;
- :mod:`.build` — builds and loads them.
"""
