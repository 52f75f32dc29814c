"""Where ``analyse`` finds its data: the config and data directories and
the versioned data layout (the port's own copy of ``umgap_tpu``'s
discovery; the on-disk layout is the same).

The reference's XDG-based directory discovery
(scripts/umgap-setup.sh:25-49, umgap-analyse.sh:17-28), its layout
(``datadir/<version>/<file>`` with symlinks in ``configdir/<version>/``,
umgap-setup.sh:205-224) and its data-version negotiation (the newest
numeric version whose config dir symlinks every needed file,
umgap-analyse.sh:233-241). Installing data needs the data server, so
the port leaves ``setup`` to ``umgap_tpu``: both read one layout.
"""

from __future__ import annotations

import os
import re
from typing import Optional

FILES = ("taxons.tsv", "tryptic.npz", "ninemer.npz")


def default_config_dir() -> str:
    """umgap-setup.sh:25-37 (XDG, macOS fallback, dot-dir fallback)."""
    xdg = os.environ.get("XDG_CONFIG_HOME")
    home = os.path.expanduser("~")
    if not xdg:
        if os.path.isdir(os.path.join(home, "Library", "Preferences")):
            return os.path.join(home, "Library", "Preferences", "Unipept")
        if os.path.isdir(os.path.join(home, ".config")):
            return os.path.join(home, ".config", "unipept")
        return os.path.join(home, ".unipept")
    return os.path.join(xdg, "unipept")


def default_data_dir() -> str:
    """umgap-setup.sh:39-49."""
    xdg = os.environ.get("XDG_DATA_HOME")
    home = os.path.expanduser("~")
    if not xdg:
        if os.path.isdir(os.path.join(home, "Library", "Application Support")):
            return os.path.join(home, "Library", "Application Support",
                                "Unipept")
        if os.path.isdir(os.path.join(home, ".local", "share")):
            return os.path.join(home, ".local", "share", "unipept")
        return os.path.join(home, ".unipept", "data")
    return os.path.join(xdg, "unipept")


def system_config_dir() -> Optional[str]:
    """The /etc/umgap system fallback (umgap-analyse.sh:95-96)."""
    return "/etc/umgap" if os.path.isdir("/etc/umgap") else None


_NUMERIC_PREFIX = re.compile(r"\s*[+-]?\d+\.?\d*")


def _sort_n_key(name: str):
    """GNU ``sort -n`` order: the leading numeric prefix orders
    ('2020-12-07' -> 2020); names without one count as 0 and sort first,
    with byte order as the last resort."""
    m = _NUMERIC_PREFIX.match(name)
    return (float(m.group(0)) if m else 0.0, name)


def discover_version(configdir: str, tryptic: bool = False,
                     ninemer: bool = False) -> Optional[str]:
    """Newest version directory whose config symlinks cover every needed
    file (umgap-analyse.sh:233-241: candidates sorted -n, the last valid
    one wins; entries must be symlinks)."""
    if not os.path.isdir(configdir):
        return None
    needed = ["taxons.tsv"]
    if tryptic:
        needed.append("tryptic.npz")
    if ninemer:
        needed.append("ninemer.npz")
    version = None
    for candidate in sorted(os.listdir(configdir), key=_sort_n_key):
        d = os.path.join(configdir, candidate)
        if os.path.isdir(d) and all(os.path.islink(os.path.join(d, name))
                                    for name in needed):
            version = candidate
    return version


def resolve(configdir: str, version: str, name: str) -> str:
    return os.path.join(configdir, version, name)
