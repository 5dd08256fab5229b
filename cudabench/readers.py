"""What the metric files under ``metrics/`` share: each metric is a file
of its own whose ``read(ctx)`` calls one of these with its own settings.
A reader that finds nothing to read returns None, and the harness leaves
the metric out of the result."""

import statistics

import flops

# The port's hand-written kernels live in anonymous namespaces of its
# CUDA sources; torch's and cuBLAS's do not.
PORT = r"\(anonymous namespace\)::"
EVAL = r"mlp_forward_kernel|heat_streams_kernel"
# Kernels of a fused trainer: the port's, without the grid's #2 and #3.
FUSED_STEP = rf"{PORT}(?!{EVAL})"
# Kernels of a step written in torch ops: everything but the port's
# kernels and copies.
TORCH_STEP = rf"^(?!.*{PORT})(?!Memcpy|Memset|Memory)"
KERNEL = r"^(?!Memcpy|Memset|Memory)"


def solve_s(ctx):
    """The window's seconds over the solves completed in it."""
    return ctx.window_s / len(ctx.calls) if ctx.calls else None


def call_seconds_quantile(ctx, q):
    """The ``q``-quantile (0 < q < 1, in tenths) of every call's own
    seconds, as ``statistics.quantiles`` cuts them."""
    times = [c.end - c.start for c in ctx.calls]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=10)[round(q * 10) - 1]


def net_steps_per_s(ctx):
    """Adam steps times the nets each advances, over the window's
    seconds."""
    done = sum(c.steps * len(c.rows) for c in ctx.calls)
    return done / ctx.window_s if ctx.calls else None


def setup_s(ctx):
    return ctx.setup_s


def overhead_ms(ctx):
    """Mean milliseconds of a call beyond the program's own training
    seconds (set-up, selection, the grid and the MAE), over the calls no
    profiler touched."""
    extra = [c.end - c.start - c.program_s for c in ctx.clean_calls
             if c.program_s is not None]
    return 1e3 * statistics.fmean(extra) if extra else None


def kernels_per_step(ctx):
    steps = ctx.steps_in_trace()
    if not steps:
        return None
    return ctx.trace.count(KERNEL) / steps


def roofline_pct(ctx, pattern):
    """The least time a step could take over the time the kernels matching
    ``pattern`` ran per step (the union of their intervals, so kernels
    that overlap on side streams count once), in percent."""
    steps = ctx.steps_in_trace()
    ops = ctx.trace.matching(pattern) if ctx.trace else []
    busy = ctx.trace.busy_s(ops) if ops else 0.0
    if not steps or not busy:
        return None
    return 100.0 * flops.bound_s(ctx.step_flops, ctx.step_bytes) \
        / (busy / steps)


def step_mfu_pct(ctx):
    """Counted operations of the steps completed by the calls no profiler
    touched, over their seconds (from the window's start to the last one's
    end) and the fp32 peak, in percent."""
    calls = ctx.clean_calls
    if not calls:
        return None
    done = sum(c.steps for c in calls) * ctx.step_flops
    seconds = calls[-1].end - ctx.window_start
    return 100.0 * done / seconds / flops.FP32_FLOPS


def device_idle_pct(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
