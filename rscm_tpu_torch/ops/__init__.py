"""
Hand-written CUDA kernels, each beside its plain PyTorch version, with a
launch count on the wrapper:

- :mod:`.udeb_month` — ``udeb_year`` (``udeb_year.launches``);
- :mod:`.lamcalc_kernel` — ``lamcalc`` (``lamcalc.launches``);
- :mod:`.build` — builds and loads them.
"""
