"""
rscm_tpu_torch — the PyTorch/CUDA port of ``rscm_tpu`` for one NVIDIA H100.

The package mirrors ``rscm_tpu``'s module paths so each counterpart is easy
to find, and keeps its own copies of what it needs: it imports neither JAX
nor anything of ``rscm_tpu``.  Models are built with the same builder
(unit, grid and schema checks), run as a Python loop over years on tensors
with the ensemble member axis written out, and the two Pallas kernels of
the TPU package are hand-written CUDA kernels here (``csrc/``), each with a
plain PyTorch version beside it (``ops/``).

Entry points (``Model.run``, ``Model.step``, ``EnsembleRunner``) run on the
CUDA card unless the caller passes ``device="cpu"``.  A model runs through
one of two executors: the year loop (batched tensors, the ensemble path)
or the step-by-step executor (one member, one step at a time, arbitrary
Python components).

Subpackages
-----------
core        Engine: time axis, timeseries, grids, units, components, model
components  The generic components (two-layer model, carbon cycle, CO2 forcing,
            four-box heat uptake, ocean-surface pCO2) and their builders
magicc      MAGICC7-derived components and the coupled MAGICC graph
parallel    Batched ensemble runner
ops         The CUDA kernels' wrappers, plain versions and build
utils       Linear algebra and the device choice
"""

__version__ = "0.1.0"
