"""`repro_torch.ann` — the public facade: :class:`Index` (build, search),
the build pipeline, regime dispatch and the numpy graph converter."""
from __future__ import annotations

from repro_torch.ann.dispatch import regime_for  # noqa: F401
from repro_torch.ann.index import Index  # noqa: F401
from repro_torch.ann.pipeline import (build_graph, build_stages,  # noqa: F401
                                      register_stage)
