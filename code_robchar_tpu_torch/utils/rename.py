"""Filename sanitizer (rename_files.py:1-26 equivalent; a copy of
code_robchar_tpu/utils/rename.py).

Cache filenames embed str(np.ndarray) noise tags containing characters some
filesystems/tools dislike; this utility renames files in a directory by
substituting those characters, mirroring the reference's helper."""

from __future__ import annotations

import os
from typing import Dict, List

DEFAULT_SUBSTITUTIONS = {"[": "(", "]": ")", " ": "_"}


def sanitize_name(name: str,
                  substitutions: Dict[str, str] | None = None) -> str:
    subs = DEFAULT_SUBSTITUTIONS if substitutions is None else substitutions
    for a, b in subs.items():
        name = name.replace(a, b)
    return name


def rename_files(directory: str, substitutions: Dict[str, str] | None = None,
                 dry_run: bool = False) -> List[tuple]:
    """Rename every file in ``directory`` whose name changes under the
    substitution map; returns [(old, new), ...]."""
    changed = []
    for fname in sorted(os.listdir(directory)):
        new = sanitize_name(fname, substitutions)
        if new != fname:
            src = os.path.join(directory, fname)
            dst = os.path.join(directory, new)
            if not dry_run:
                os.rename(src, dst)
            changed.append((fname, new))
    return changed


if __name__ == "__main__":
    import sys
    for old, new in rename_files(sys.argv[1] if len(sys.argv) > 1 else "."):
        print(f"{old} -> {new}")
