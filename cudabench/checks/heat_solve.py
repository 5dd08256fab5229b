"""A heat solve's answer held against the plain reference: its first three
training steps (initial weights, draws, loss, gradient and Adam update),
its trained net on the 40×40 grid (kernel #2's evaluation) and its MAE.

Numbers: ``loss_gap`` (first three losses, relative), ``grid_gap`` (the
widest gap of the returned solution from the reference's forward pass of
the returned net, relative to the solution's largest value), ``mae_gap``
(the reported MAE against the MAE of the reported solution, relative: the
answer's two parts agree), ``mae`` (the reference's MAE of the returned
net: the configuration's stated limit holds it) and ``bad_losses``
(missing or non-finite losses)."""

import math

import numpy as np
import torch

from checks import first_steps
from reference import nets


def grid(nodes, device):
    """The heat grid's [nodes², 2] (x, t) rows, time-major, and the exact
    solution sin(x)·e^(−t) on it (the reference's heat.py:152-166)."""
    t = torch.linspace(0.0, 3.0, nodes, device=device)
    x = torch.linspace(0.0, math.pi, nodes, device=device)
    tt, xx = torch.meshgrid(t, x, indexing="ij")
    rows = torch.stack([xx.reshape(-1), tt.reshape(-1)], 1)
    tn, xn = np.linspace(0.0, 3.0, nodes), np.linspace(0.0, math.pi, nodes)
    return rows, np.sin(xn)[None, :] * np.exp(-tn)[:, None]


def grid_numbers(cfg, params, solution, mae, device):
    """``grid_gap``, ``mae_gap`` and ``mae`` of a solution and its MAE,
    against the reference's forward pass of ``params`` and the exact
    solution."""
    rows, exact = grid(cfg["nodes"], device)
    with torch.no_grad():
        want = nets.forward(cfg, params, rows)
    want = want.double().cpu().numpy().reshape(exact.shape)
    got = np.asarray(solution, np.float64).reshape(exact.shape)
    ref_mae = float(np.mean(np.abs(exact - want)))
    own_mae = float(np.mean(np.abs(exact - got)))
    return {"grid_gap": float(np.max(np.abs(got - want))
                              / np.max(np.abs(want))),
            "mae_gap": abs(float(mae) - own_mae) / own_mae,
            "mae": ref_mae}


def numbers(cell, call, device, deep=True):
    mix, cfg, res = cell.mix, cell.cfg, call.answer
    losses = np.asarray(res.loss_history, np.float64)[None, :]
    want = first_steps.reference_losses(mix, cfg, call.seed, call.rows,
                                        device)
    params = {k: v.to(device) for k, v in
              nets.read_params(res.params).items()}
    out = {"loss_gap": first_steps.gap(losses, want)}
    out.update(grid_numbers(cfg, params, res.solution, res.mae, device))
    out["bad_losses"] = first_steps.bad_losses(losses, 1, call.steps)
    return out
