"""The comparisons that decide a run's ``correct``: each module's
``numbers(cell, call, device)`` reads one call's answer and returns
the numbers the harness holds against the cell's limits."""
