"""Figure reproduction.

Recreates the reference's result figures (heat.py:234-287 3-panel heat
figure; simple_ode.py:196-237, fredholm.py:198-245, fitzhugh_nagumo.py:240-301
solution+loss panels; ablation curves with zoom inset,
batchsize_effect_heat.py:210-240) from the saved ``temp_results/*.npy``
artifacts. Headless-safe (Agg backend). The JAX package's figures, the
same signatures and layout, with numpy and matplotlib only: either
package's arrays plot the same."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from differential_equations_dnn_tpu_torch.train.metrics import (  # noqa: E402
    mean_absolute_error,
)

plt.style.use("tableau-colorblind10")


def _finish(fig, savepath, show):
    if savepath:
        from pathlib import Path

        Path(savepath).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(savepath)
        print(f"Saved figure to {savepath}")
    if show:
        plt.show()
    return fig


def plot_solution_and_loss(grid, y_exact, y_approx, loss, title,
                           savepath=None, show=False, ylabel="y(t)"):
    """Generic 2-panel figure: exact-vs-approx solution and training loss,
    with the MAE annotated (the reference's per-ODE layout)."""
    mae = mean_absolute_error(y_exact, y_approx)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    ax1.plot(grid, y_exact, lw=2.0, label="Exact")
    ax1.plot(grid, y_approx, "x", ms=6, label="DGM approximation")
    ax1.set_xlabel("t", fontsize=14, weight="bold")
    ax1.set_ylabel(ylabel, fontsize=14, weight="bold")
    ax1.legend()
    ax1.set_title(title)
    ax2.plot(loss, lw=2.0)
    ax2.set_xlabel("Iterations", fontsize=14, weight="bold")
    ax2.set_ylabel("Loss", fontsize=14, weight="bold")
    ax2.set_yscale("log")
    ax2.text(0.4, 0.8, f"DGM MAE: {np.round(mae, 4)}",
             transform=ax2.transAxes, fontsize=13, weight="bold")
    fig.tight_layout()
    return _finish(fig, savepath, show), mae


def plot_heat(y_exact, y_dgm, loss, n_iters, savepath=None, show=False,
              vmin=0.0, vmax=1.0):
    """The 3-panel space-time-field figure (heat.py:234-287): exact field,
    approximated field, loss curve with MAE annotation. Pass vmin=vmax=None
    for auto colour scaling (non-heat fields, e.g. Burgers)."""
    mae = mean_absolute_error(y_exact, y_dgm)
    fig = plt.figure(figsize=(20, 5))
    fig.subplots_adjust(bottom=0.11)
    for idx, (field, name) in enumerate(
        [(y_exact, "Exact solution"), (y_dgm, "Approximated solution (DNN)")]
    ):
        ax = fig.add_subplot(1, 3, idx + 1)
        im = ax.imshow(field, origin="lower", vmin=vmin, vmax=vmax)
        plt.colorbar(im)
        ax.set_xlabel("Space", fontsize=16, weight="bold")
        ax.set_ylabel("Time", fontsize=16, weight="bold")
        ax.title.set_text(name)
    ax = fig.add_subplot(133)
    ax.plot(np.asarray(loss), lw=2.0)
    ax.set_xlabel("Iterations", fontsize=16, weight="bold")
    ax.set_ylabel("Loss", fontsize=16, weight="bold")
    ax.text(0.55 * n_iters, 0.5 * float(np.max(loss)),
            f"DGM MAE: {np.round(mae, 4)}", fontsize=13, weight="bold")
    return _finish(fig, savepath, show), mae


def plot_fitzhugh_nagumo(t_grid, y_exact, y_dgm, loss, savepath=None, show=False):
    """Both components vs odeint ground truth + loss
    (fitzhugh_nagumo.py:240-301)."""
    mae = mean_absolute_error(y_exact, y_dgm)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
    ax1.plot(t_grid, y_exact[:, 0], lw=2.0, label="y (odeint)")
    ax1.plot(t_grid, y_exact[:, 1], lw=2.0, label="w (odeint)")
    ax1.plot(t_grid, y_dgm[:, 0], "x", ms=5, label="y (DGM)")
    ax1.plot(t_grid, y_dgm[:, 1], "+", ms=5, label="w (DGM)")
    ax1.set_xlabel("Time", fontsize=14, weight="bold")
    ax1.legend()
    ax2.plot(loss, lw=2.0)
    ax2.set_yscale("log")
    ax2.set_xlabel("Iterations", fontsize=14, weight="bold")
    ax2.set_ylabel("Loss", fontsize=14, weight="bold")
    ax2.text(0.4, 0.8, f"DGM MAE: {np.round(mae, 4)}",
             transform=ax2.transAxes, fontsize=13, weight="bold")
    fig.tight_layout()
    return _finish(fig, savepath, show), mae


def plot_ablation(curves: dict, savepath=None, show=False, smooth: int = 50,
                  inset: bool = True):
    """Loss curves per configuration with a zoomed tail inset
    (batchsize_effect_heat.py:210-240, batchnorm_effect_heat.py:357-398)."""
    fig, ax = plt.subplots(figsize=(10, 6))

    def smoothed(y):
        if smooth <= 1 or len(y) < smooth:
            return np.asarray(y)
        kernel = np.ones(smooth) / smooth
        return np.convolve(y, kernel, mode="valid")

    for label, losses in curves.items():
        ax.plot(smoothed(losses), lw=1.5, label=str(label))
    ax.set_xlabel("Iterations", fontsize=14, weight="bold")
    ax.set_ylabel("Loss", fontsize=14, weight="bold")
    ax.set_yscale("log")
    ax.legend(ncol=2, fontsize=9)

    if inset:
        axins = ax.inset_axes([0.55, 0.55, 0.4, 0.4])
        for label, losses in curves.items():
            y = smoothed(losses)
            tail = y[int(0.8 * len(y)):]
            axins.plot(np.arange(int(0.8 * len(y)), len(y)), tail, lw=1.0)
        axins.set_yscale("log")
        axins.set_title("final 20%", fontsize=9)
    return _finish(fig, savepath, show)
