"""
Progress reporting for long calibrations.

Port of ``rscm_tpu/calibrate/progress.py`` (host code, copied as it is).
The sampler emits :class:`~rscm_tpu_torch.calibrate.sampler.ProgressInfo` records
(iteration, total, acceptance rate, mean log prob) to any callable passed as
``progress_callback``; this module provides the three standard consumers the
reference ships (`python/rscm/calibrate/progress.py` API surface): a tqdm
bar, a plain-text printer, and a metrics recorder.

The device engine reports once per checkpoint segment (about twenty times a
run when it does not checkpoint) — all consumers here are written against
``ProgressInfo`` alone and make no per-iteration assumptions.
"""

from __future__ import annotations

__all__ = ["ProgressTracker", "create_simple_callback", "create_tqdm_callback"]


def _one_based(info) -> int:
    """ProgressInfo.iteration is 0-indexed; humans read 1-indexed."""
    return info.iteration + 1


def _is_report_point(info, every: int) -> bool:
    """Report every ``every`` iterations, and always on the final one."""
    done = _one_based(info)
    return done % every == 0 or done == info.total


def _format_line(info) -> str:
    done = _one_based(info)
    pct = 100.0 * done / info.total
    return (
        f"Iteration {done}/{info.total} ({pct:.1f}%) | "
        f"Acceptance rate: {info.acceptance_rate:.3f} | "
        f"Mean log prob: {info.mean_log_prob:.2f}"
    )


class _TqdmCallback:
    """Callable that mirrors sampler progress onto a tqdm bar.

    Exposes ``.pbar`` and ``.close`` (the reference's contract) so callers
    can flush/close the bar explicitly.
    """

    def __init__(self, pbar):
        self.pbar = pbar

    def __call__(self, info):
        self.pbar.n = _one_based(info)
        self.pbar.set_postfix(
            acc_rate=f"{info.acceptance_rate:.3f}",
            mean_log_p=f"{info.mean_log_prob:.2f}",
            refresh=True,
        )

    def close(self):
        self.pbar.close()


def create_tqdm_callback(total: int, desc: str = "Sampling", **tqdm_kwargs):
    """Progress callback driving a tqdm bar; pass to ``sampler.run(...)``.

    ``total``/``desc`` seed the bar; any extra keyword arguments are handed
    straight to the tqdm constructor (and may override the seeds).
    """
    try:
        from tqdm.auto import tqdm
    except ImportError:
        raise ImportError(
            "tqdm is required for progress bar display. Install with: pip install tqdm"
        ) from None

    opts = {"total": total, "desc": desc, "unit": "iter", **tqdm_kwargs}
    return _TqdmCallback(tqdm(**opts))


def create_simple_callback(print_every: int = 100):
    """Text-only progress callback printing every ``print_every`` iterations."""

    def callback(info):
        if _is_report_point(info, print_every):
            print(_format_line(info))

    return callback


class ProgressTracker:
    """Callback object that records per-callback metrics for later analysis.

    Appends (iteration, acceptance_rate, mean_log_prob) on every call;
    with ``print_every > 0`` it additionally prints at that cadence.
    """

    def __init__(self, print_every: int = 0):
        self.print_every = print_every
        self.iterations: list = []
        self.acceptance_rates: list = []
        self.mean_log_probs: list = []

    def __call__(self, info):
        self.iterations.append(info.iteration)
        self.acceptance_rates.append(info.acceptance_rate)
        self.mean_log_probs.append(info.mean_log_prob)
        if self.print_every > 0 and _is_report_point(info, self.print_every):
            print(_format_line(info))

    def clear(self):
        del self.iterations[:]
        del self.acceptance_rates[:]
        del self.mean_log_probs[:]
