"""Where ``analyse`` looks for FragGeneScan++ (the port's own copy of
``umgap_tpu``'s discovery; the on-disk layout is the same).

The reference's precision presets pipe reads through FGSpp when it is
installed under the config dir (umgap-analyse.sh:248-251, 276-311). The
port cannot run it yet, so ``analyse`` uses these only to refuse, for
such a preset, a run that would give other taxa than ``umgap_tpu``'s.
"""

from __future__ import annotations

import os

# Presets whose reference pipeline runs FGSpp (umgap-analyse.sh cases)
FGSPP_PRESETS = frozenset({
    "tryptic-sensitivity", "tryptic-precision",
    "high-precision", "max-precision",
})


def find_fgspp(configdir: str):
    """(binary, train dir) when FGSpp is installed under the config dir
    the way umgap-setup lays it out; None otherwise."""
    binary = os.path.join(configdir, "FGSpp", "FGSpp")
    train = os.path.join(configdir, "FGSpp", "train")
    if os.path.isfile(binary) and os.access(binary, os.X_OK) \
            and os.path.isdir(train):
        return binary, train
    return None


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
