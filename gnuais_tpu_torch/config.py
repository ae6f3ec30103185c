"""Configuration: gnuais-compatible config file + CLI, with TPU
extensions.

Implements the reference's two-layer config (cfg.c, cfgfile.c):
 - directive table with case-insensitive PREFIX matching (strncasecmp
   against the typed token, cfgfile.c:326 — ``soundch both`` works);
 - quoted/escaped tokens (parse_args/parse_string);
 - interval syntax "1d2h3m4s" (parse_interval, cfg.c:152-183);
 - one skip_type value per directive (cfg.c:203-220);
 - uplink directives ``Uplink <name> json <url>``;
 - soundchannels mono/both/left/right.

TPU extensions (new knobs, all optional): streams, blocklen,
frameslots, meshshape, backend (exact|fast), iq input mode.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from gnuais_tpu_torch.constants import (
    SOUND_CHANNELS_BOTH,
    SOUND_CHANNELS_LEFT,
    SOUND_CHANNELS_MONO,
    SOUND_CHANNELS_RIGHT,
    MAX_AIS_PACKET_TYPE,
)


def parse_interval(s: str) -> int:
    """'1d2h3m4s' -> seconds (cfg.c:152-183)."""
    t = 0
    num = ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            c = ch.lower()
            v = int(num) if num else 0
            if c == "s":
                t += v
            elif c == "m":
                t += 60 * v
            elif c == "h":
                t += 3600 * v
            elif c == "d":
                t += 86400 * v
            num = ""
    if num:
        t += int(num)
    return t


def parse_args_line(line: str) -> List[str]:
    """Tokenize a config line with quoting and backslash escapes
    (parse_args/parse_string, cfgfile.c:186-288)."""
    argv: List[str] = []
    i, n = 0, len(line)
    while i < n:
        while i < n and line[i].isspace():
            i += 1
        if i >= n:
            break
        if line[i] == '"':
            i += 1
            buf = []
            while i < n and line[i] != '"':
                if line[i] == "\\" and i + 1 < n:
                    i += 1
                buf.append(line[i])
                i += 1
            i += 1  # closing quote
            argv.append("".join(buf))
        else:
            j = i
            while j < n and not line[j].isspace():
                j += 1
            argv.append(line[i:j])
            i = j
    return argv


@dataclass
class UplinkConfig:
    name: str
    proto: str
    url: str


@dataclass
class Config:
    # reference-compatible knobs (cfg.h:42-94)
    logdir: Optional[str] = None
    mycall: str = "N0CALL"
    myemail: Optional[str] = None
    mylat: float = -200.0
    mylng: float = -200.0
    stats_interval: int = 0
    expiry_interval: int = 0
    uplinks: List[UplinkConfig] = field(default_factory=list)
    mysql_host: Optional[str] = None
    mysql_db: Optional[str] = None
    mysql_user: Optional[str] = None
    mysql_password: Optional[str] = None
    mysql_keepsmall: bool = False
    mysql_oldlimit: int = 0
    sound_device: Optional[str] = None
    sound_in_file: Optional[str] = None
    sound_out_file: Optional[str] = None
    sound_channels: int = SOUND_CHANNELS_MONO
    sound_levellog: int = 0
    serial_port: Optional[str] = None
    skip_type: List[int] = field(default_factory=list)

    # TPU extensions
    streams: int = 1
    blocklen: int = 49_152
    frameslots: int = 32
    meshshape: Tuple[int, ...] = ()
    backend: str = "exact"       # exact | fast | golden
    input_format: str = "audio"  # audio | iq
    iq_decim: int = 4            # IQ input rate = 48 kHz * iq_decim
    db_path: Optional[str] = None  # sqlite sink
    # exact checkpoint/resume + automatic mid-run recovery
    # (runtime.supervisor): per-channel snapshots at <path>.<channel>
    checkpoint: Optional[str] = None
    checkpoint_every: int = 64   # blocks between snapshots
    # per-time-shard samples in mesh (meshshape) decode; the streaming
    # super-block is timepar_block * n_time_shards samples per channel
    timepar_block: int = 65_536
    # lanes-mode envelope guard: scan whole-capture lane decodes for
    # constant-level runs longer than the resync overlap (outside the
    # documented exactness envelope, parallel/timepar.py:29-40) and
    # fall back to the exact streaming session
    lanes_guard: bool = True
    # jax.profiler trace output directory (--profile); None = off
    profile_dir: Optional[str] = None
    # multi-host fleet (--cluster coordinator:port nprocs procid):
    # jax.distributed multi-controller launch, one process per host
    cluster_coordinator: Optional[str] = None
    cluster_nprocs: int = 0
    cluster_procid: int = -1

    @property
    def have_my_loc(self) -> bool:
        return -90 < self.mylat < 90 and -180 < self.mylng < 180


class ConfigError(Exception):
    pass


def _set_sound_ch(cfg: Config, argv: List[str]) -> None:
    if len(argv) < 2:
        raise ConfigError("soundchannels needs a value")
    v = argv[1].lower()
    m = {"mono": SOUND_CHANNELS_MONO, "both": SOUND_CHANNELS_BOTH,
         "left": SOUND_CHANNELS_LEFT, "right": SOUND_CHANNELS_RIGHT}
    if v not in m:
        raise ConfigError(f"unknown soundchannels value: {argv[1]}")
    cfg.sound_channels = m[v]


def _set_skip_type(cfg: Config, argv: List[str]) -> None:
    """The reference marks one type per directive (do_skip_type,
    cfg.c:203-220, reads only argv[1]); accepting every listed value is
    a compatible superset (``skip_type 4 5 8``)."""
    if len(argv) < 2:
        raise ConfigError("skip_type needs a value")
    for tok in argv[1:]:
        i = int(tok)
        if not (0 < i <= MAX_AIS_PACKET_TYPE):
            raise ConfigError(f"skip_type value out of range: {i}")
        if i not in cfg.skip_type:
            cfg.skip_type.append(i)


def _set_uplink(cfg: Config, argv: List[str]) -> None:
    if len(argv) < 4:
        raise ConfigError("uplink needs: Uplink <name> json <url>")
    if argv[2].lower() != "json":
        raise ConfigError(f"Unsupported uplink protocol '{argv[2]}'")
    cfg.uplinks.insert(0, UplinkConfig(argv[1], "json", argv[3]))


# directive name -> setter(cfg, argv); names must stay unique under
# prefix matching resolution order (first match in table order wins,
# like the reference's linear scan)
_DIRECTIVES = [
    ("logdir", lambda c, a: setattr(c, "logdir", a[1])),
    ("mycall", lambda c, a: setattr(c, "mycall", a[1])),
    ("myemail", lambda c, a: setattr(c, "myemail", a[1])),
    ("latitude", lambda c, a: setattr(c, "mylat", float(a[1]))),
    ("longitude", lambda c, a: setattr(c, "mylng", float(a[1]))),
    ("statsinterval", lambda c, a: setattr(c, "stats_interval", parse_interval(a[1]))),
    ("expiryinterval", lambda c, a: setattr(c, "expiry_interval", parse_interval(a[1]))),
    ("uplink", _set_uplink),
    ("mysql_host", lambda c, a: setattr(c, "mysql_host", a[1])),
    ("mysql_db", lambda c, a: setattr(c, "mysql_db", a[1])),
    ("mysql_user", lambda c, a: setattr(c, "mysql_user", a[1])),
    ("mysql_password", lambda c, a: setattr(c, "mysql_password", a[1])),
    ("mysql_keepsmall", lambda c, a: setattr(c, "mysql_keepsmall", True)),
    ("mysql_oldlimit", lambda c, a: setattr(c, "mysql_oldlimit", int(a[1]))),
    ("sounddevice", lambda c, a: setattr(c, "sound_device", a[1])),
    ("soundinfile", lambda c, a: setattr(c, "sound_in_file", a[1])),
    ("soundoutfile", lambda c, a: setattr(c, "sound_out_file", a[1])),
    ("soundchannels", _set_sound_ch),
    ("soundlevellog", lambda c, a: setattr(c, "sound_levellog", int(a[1]))),
    ("serialport", lambda c, a: setattr(c, "serial_port", a[1])),
    ("serial_port", lambda c, a: setattr(c, "serial_port", a[1])),
    ("skip_type", _set_skip_type),
    # --- TPU extensions ---
    ("streams", lambda c, a: setattr(c, "streams", int(a[1]))),
    ("blocklen", lambda c, a: setattr(c, "blocklen", int(a[1]))),
    ("frameslots", lambda c, a: setattr(c, "frameslots", int(a[1]))),
    ("meshshape", lambda c, a: setattr(c, "meshshape", tuple(int(x) for x in a[1:]))),
    ("backend", lambda c, a: setattr(c, "backend", a[1].lower())),
    ("inputformat", lambda c, a: setattr(c, "input_format", a[1].lower())),
    ("iqdecim", lambda c, a: setattr(c, "iq_decim", int(a[1]))),
    ("dbpath", lambda c, a: setattr(c, "db_path", a[1])),
    ("checkpoint", lambda c, a: setattr(c, "checkpoint", a[1])),
    ("checkpointevery",
     lambda c, a: setattr(c, "checkpoint_every", int(a[1]))),
    ("timeparblock",
     lambda c, a: setattr(c, "timepar_block", int(a[1]))),
    ("lanesguard",
     lambda c, a: setattr(c, "lanes_guard",
                          a[1].lower() not in ("off", "0", "false", "no"))),
]


def apply_directive(cfg: Config, line: str) -> bool:
    """Apply one config line; returns False for unknown directives.
    Comment lines start with '#'; blank lines are ignored."""
    argv = parse_args_line(line)
    if not argv or argv[0].startswith("#"):
        return True
    tok = argv[0].lower()
    for name, fn in _DIRECTIVES:
        if name.startswith(tok):     # prefix match, reference quirk
            fn(cfg, argv)
            return True
    return False


def read_config(path: str, cfg: Optional[Config] = None) -> Config:
    cfg = cfg or Config()
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            if not apply_directive(cfg, line):
                raise ConfigError(
                    f"{path}:{lineno}: no such configuration directive: "
                    f"{line.split()[0]}")
    return cfg


def default_config_dir() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME") or os.path.expanduser("~/.config")
    return Path(base) / "gnuais"


def packaged_example() -> Optional[Path]:
    """The shipped gnuais-tpu.conf-example (repo root / install data)."""
    for cand in (Path(__file__).resolve().parent.parent
                 / "gnuais-tpu.conf-example",
                 Path("/usr/share/doc/gnuais/gnuais.conf-example"),
                 Path("/usr/local/share/doc/gnuais/gnuais.conf-example")):
        if cand.exists():
            return cand
    return None


def auto_install_config(log=None) -> Optional[Path]:
    """First-run behavior of the reference (cfgfile.c:341-422): when no
    config exists, create ~/.config/gnuais/config from /etc/gnuais.conf
    or the packaged example.  Returns the path to a readable config, or
    None when nothing exists and nothing could be installed."""
    conf = default_config_dir() / "config"
    if conf.exists():
        return conf
    try:
        conf.parent.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    src = Path("/etc/gnuais.conf")
    if not src.exists():
        src = packaged_example()
    if src is None:
        if log:
            log.error("No gnuais.conf-example found to be copied to %s",
                      conf)
        return None
    try:
        conf.write_text(src.read_text())
    except OSError:
        return None
    if log:
        log.warning("Created %s from %s — you should edit this file!",
                    conf, src)
    return conf


def resolve_config(path: Optional[str], cfg: Optional[Config] = None,
                   log=None) -> Config:
    """-c path when given; otherwise the auto-installed default config
    (reference behavior: missing config is not an error — defaults
    apply with a warning)."""
    if path:
        return read_config(path, cfg)
    conf = auto_install_config(log)
    if conf is None:
        if log:
            log.warning("No configuration file found! Running with the "
                        "default configuration.")
        return cfg or Config()
    return read_config(str(conf), cfg)
