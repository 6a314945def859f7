"""Checkpoints of the port: per-leaf files and a manifest in the
reference's layout, atomic commit, asynchronous saves, and the
consolidation plan."""
from .store import (  # noqa: F401
    AsyncCheckpointer, latest_step, plan_consolidation, restore,
    restore_latest, save, shrink_consolidation,
)
