"""Wall-clock timing — the reference's entire profiling system was the
``fn_timer`` decorator (auxiliary_funs.py:22-30). Kept for parity, plus a
context-manager Timer that also reports rates. For deep profiling use
``torch.profiler`` (the scan trainer's ``profile_dir`` option writes its
trace: ``train(..., profile_dir=...)``); a CUDA device runs asynchronously,
so time it after ``torch.cuda.synchronize()``."""

import functools
import time


def fn_timer(function):
    """Print wall-clock runtime of ``function`` (reference-compatible:
    auxiliary_funs.py:22-30 prints 'Total time running …')."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = function(*args, **kwargs)
        t1 = time.perf_counter()
        print(f"Total time running {function.__name__}: {t1 - t0:.3f} seconds")
        return result

    return wrapper


class Timer:
    """Context-manager stopwatch: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False

    def rate(self, n):
        return n / self.elapsed if self.elapsed > 0 else float("inf")
