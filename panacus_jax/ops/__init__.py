from .engine import (  # noqa: F401
    CountingEngine,
    dedup_pairs,
    membership_from_pairs,
    coverage_from_membership,
)
