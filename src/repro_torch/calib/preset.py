"""Versioned calibrated-constant artifacts.

A :class:`CalibratedTech` bundles fitted constants with everything needed to
trust (or reject) them later: the content digest of the constants, the
digest + source tags of the measurements they were fitted on, the free-field
list, and the before/after error report.  Artifacts serialize to JSON
(atomic write), load by path or — via ``$REPRO_CALIB_DIR`` — by name through
``core.presets.tech_preset``, and register themselves so
``Session(tech="<name>")`` resolves them anywhere in the stack (workers
included).

The port's own copy of ``repro.calib.preset``: the same JSON schema and
digest checks, so an artifact either package writes loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, Tuple

from ..core.constants import (TechConstants, tech_from_dict, tech_key,
                              tech_to_dict)
from ..core.presets import register_tech

SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class CalibratedTech:
    """A named, versioned, provenance-carrying TechConstants artifact."""
    name: str
    tech: TechConstants
    base_digest: str                    # tech_key of the starting constants
    source_digest: str                  # measurements content digest
    sources: Tuple[str, ...]            # measurement source tags
    free: Tuple[str, ...]               # fields the fit was allowed to move
    fitted: Dict[str, float]            # field -> fitted value
    errors: Dict[str, Dict[str, float]]  # split -> per-metric rel error
    created: float = 0.0                # unix seconds

    @property
    def digest(self) -> str:
        return tech_key(self.tech)

    @classmethod
    def from_fit(cls, name: str, res) -> "CalibratedTech":
        """Wrap a :class:`repro_torch.calib.fit.FitResult` as a named
        artifact."""
        return cls(name=str(name), tech=res.tech,
                   base_digest=tech_key(res.tech0),
                   source_digest=res.source_digest, sources=res.sources,
                   free=res.free, fitted=dict(res.fitted),
                   errors={k: dict(v) for k, v in res.errors.items()},
                   created=time.time())

    def to_dict(self) -> Dict:
        return {
            "schema": SCHEMA,
            "name": self.name,
            "digest": self.digest,
            "base_digest": self.base_digest,
            "source_digest": self.source_digest,
            "sources": list(self.sources),
            "free": list(self.free),
            "fitted": self.fitted,
            "errors": self.errors,
            "created": self.created,
            "tech": tech_to_dict(self.tech),
        }

    @classmethod
    def from_dict(cls, doc: Dict) -> "CalibratedTech":
        tech = tech_from_dict(doc["tech"])
        stored = doc.get("digest")
        if stored and stored != tech_key(tech):
            raise ValueError(
                f"calibrated artifact {doc.get('name')!r} digest mismatch: "
                f"stored {stored[:12]} != content {tech_key(tech)[:12]}")
        return cls(name=str(doc["name"]), tech=tech,
                   base_digest=doc.get("base_digest", ""),
                   source_digest=doc.get("source_digest", ""),
                   sources=tuple(doc.get("sources", ())),
                   free=tuple(doc.get("free", ())),
                   fitted=dict(doc.get("fitted", {})),
                   errors={k: dict(v)
                           for k, v in doc.get("errors", {}).items()},
                   created=float(doc.get("created", 0.0)))

    def save(self, out_dir: str) -> str:
        """Atomically write ``<out_dir>/<name>.json`` and register the
        preset in-process; returns the path."""
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{self.name}.json")
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.register()
        return path

    def register(self) -> "CalibratedTech":
        register_tech(self.name, self.tech)
        return self


def load_calibrated(path: str) -> CalibratedTech:
    """Load + digest-verify + register a CalibratedTech artifact."""
    with open(path) as f:
        doc = json.load(f)
    art = CalibratedTech.from_dict(doc)
    art.register()
    return art
