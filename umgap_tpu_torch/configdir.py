"""Where ``analyse`` finds its data: the config and data directories and
the versioned data layout (the port's own copy of ``umgap_tpu``'s
discovery; the on-disk layout is the same).

The reference's XDG-based directory discovery
(scripts/umgap-setup.sh:25-49, umgap-analyse.sh:17-28), its layout
(``datadir/<version>/<file>`` with symlinks in ``configdir/<version>/``,
umgap-setup.sh:205-224), its data-version negotiation (the newest
numeric version whose config dir symlinks every needed file,
umgap-analyse.sh:233-241), and ``setup``'s install: local files (the
offline route) or the data server's, whose calls go through
``urllib.request.urlopen``. Either package installs what the other
reads.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, Optional

DATASERVER = "https://unipept.ugent.be/system/umgap"
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


def latest_server_version(server: str = DATASERVER, timeout: int = 30) -> str:
    """GET {server}/latest (umgap-setup.sh:168-173). Needs the network."""
    from urllib import request

    with request.urlopen(f"{server}/latest", timeout=timeout) as res:
        return res.read().decode().strip()


def install(configdir: str, datadir: str, version: str,
            sources: Dict[str, str], log=None) -> None:
    """Install artifact files for a version: copy each source into
    ``datadir/<version>/``, chmod 644, and symlink it from
    ``configdir/<version>/`` (umgap-setup.sh:205-224). ``sources`` maps
    artifact names ('taxons.tsv', 'tryptic.npz', 'ninemer.npz') to local
    paths (the offline route) or http(s) URLs."""
    os.makedirs(os.path.join(datadir, version), exist_ok=True)
    os.makedirs(os.path.join(configdir, version), exist_ok=True)
    for name, src in sources.items():
        if name not in FILES:
            raise ValueError(f"unknown artifact {name!r}; expected {FILES}")
        dst = os.path.join(datadir, version, name)
        if src.startswith(("http://", "https://")):
            from urllib import request

            if log:
                log(f"downloading {src}")
            with request.urlopen(src, timeout=600) as res, \
                    open(dst, "wb") as f:
                shutil.copyfileobj(res, f)
        else:
            if log:
                log(f"installing {src}")
            shutil.copyfile(src, dst)
        os.chmod(dst, 0o644)
        link = os.path.join(configdir, version, name)
        if os.path.islink(link) or os.path.exists(link):
            os.unlink(link)
        # an absolute target: a relative datadir would resolve against
        # the link's directory and dangle
        os.symlink(os.path.abspath(dst), link)


def sniff_open(path: str, mode: str = "rt"):
    """Open a file that may be gzipped, by its magic bytes (the reference
    pipelines take gzipped inputs, umgap-visualize.sh:141)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        import gzip

        return gzip.open(path, mode)
    return open(path, mode)
