"""The cardinality governor's configuration and report: counterpart of
``nos_tpu/obsplane/governor.py``.

Admission (``util/metrics.py``'s ``_admit_child``) depends only on the
set of label sets a family already holds: its first ``budget`` distinct
label sets are exact, every later one folds into one ``_other`` child,
so the same emissions give the same exposition bytes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple


def budgets_from(obs) -> Tuple[Dict[str, int], Optional[int]]:
    """(family → budget, the default budget) of an ``ObservabilityConfig``;
    a default of 0 or None leaves the other families unbudgeted."""
    budgets = {name: int(v) for name, v in (obs.series_budget or {}).items()}
    default = obs.series_budget_default
    if default is not None and default <= 0:
        default = None
    return budgets, default


def governor_report(registry) -> dict:
    """Totals and each family's series accounting; ``over_budget`` names
    the families folding into ``_other``."""
    families = registry.series_report()
    return {"active_series": sum(f["exact"] + f["overflow"] for f in families.values()),
            "dropped_series": sum(f["dropped"] for f in families.values()),
            "over_budget": sorted(name for name, f in families.items() if f["dropped"]),
            "families": families}
