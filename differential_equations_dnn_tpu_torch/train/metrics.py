"""The reference's acceptance metric: sklearn.metrics.mean_absolute_error
against the analytic solution (heat.py:232), written out directly."""

import numpy as np


def mean_absolute_error(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float(np.mean(np.abs(y_true - y_pred)))
