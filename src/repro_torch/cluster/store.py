"""NFS-Ganesha analogue: a versioned artifact store with atomic writes.

SEIFER provisions a cluster-wide NFS server whose lifecycle is independent of
every pod, so crashed pods can restart their inference runtime from stored
partition files.  Here: a directory of ``<version>/<name>.npz`` artifacts
written atomically (tmp + rename), plus a ``VERSION`` pointer file.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any

import numpy as np


class ArtifactStore:
    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # -- version pointer ----------------------------------------------------
    def current_version(self) -> int:
        vf = self.root / "VERSION"
        return int(vf.read_text()) if vf.exists() else -1

    def _set_version(self, v: int) -> None:
        self._atomic_write(self.root / "VERSION", str(v).encode())

    @staticmethod
    def _atomic_write(path: Path, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # -- artifacts ------------------------------------------------------------
    def _vdir(self, version: int) -> Path:
        d = self.root / f"v{version:06d}"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def put_arrays(self, version: int, name: str, arrays: dict[str, np.ndarray]) -> None:
        import io

        buf = io.BytesIO()
        np.savez(buf, **arrays)
        self._atomic_write(self._vdir(version) / f"{name}.npz", buf.getvalue())

    def get_arrays(self, version: int, name: str) -> dict[str, np.ndarray]:
        with np.load(self._vdir(version) / f"{name}.npz") as z:
            return {k: z[k] for k in z.files}

    def put_json(self, version: int, name: str, obj: Any) -> None:
        self._atomic_write(
            self._vdir(version) / f"{name}.json", json.dumps(obj, indent=1).encode()
        )

    def get_json(self, version: int, name: str) -> Any:
        return json.loads((self._vdir(version) / f"{name}.json").read_text())

    def publish(self, version: int) -> None:
        """Flip the version pointer after all artifacts are written."""
        self._set_version(version)

    def exists(self, version: int, name: str, ext: str = "npz") -> bool:
        return (self.root / f"v{version:06d}" / f"{name}.{ext}").exists()
