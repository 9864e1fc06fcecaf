"""Configuration system.

Parity with the reference ``include/settings.h`` (Settings struct,
``Settings::LoadFromFile`` key=value parser) and the CLI defaults of
``src/main.cpp:89-301``: identical key names, defaults, and precedence
(settings file provides defaults, CLI overrides).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class CycleFinderSettings:
    # Defaults: reference include/settings.h:33-38
    threshold_multiplicity: int = 20
    # Parsed + stored but DELIBERATELY unwired — faithful to the
    # reference, where the flag only gates a *redundant second*
    # InvalidateMultiplicityOneNodes call (src/cycle_finder.cpp:391-393);
    # the unconditional call at :439 already ran, so the gated one is a
    # no-op either way. Kept so settings files round-trip identically.
    low_abundance: bool = True
    cycle_max_length: int = 77
    cycle_min_length: int = 27


@dataclass
class DNASequenceSettings:
    # Defaults: reference include/settings.h:39-44
    spacer_min_length: int = 23
    spacer_max_length: int = 50
    repeat_min_length: int = 23
    repeat_max_length: int = 50


@dataclass
class Settings:
    input_files: str = ""  # space-joined list, like the reference
    ram: float = 0.0  # GB
    ram_explicit: bool = False  # True when --ram / settings-file ram was given
    threads: int = 0
    output_folder: str = ""
    graph_folder: str = ""
    cycles_folder: str = ""
    output_file: str = ""
    benchmark_file: str = ""
    cycle_finder_settings: CycleFinderSettings = field(default_factory=CycleFinderSettings)
    dna_sequence_settings: DNASequenceSettings = field(default_factory=DNASequenceSettings)

    # Framework-specific knobs (not in the reference):
    add_reverse_complement: bool = True  # megahit's graph contains both strands
    deterministic: bool = True  # stable start-node order / canonical output
    debug_pipeline: bool = False  # run the reference's DEBUG-main extension
    resume: bool = False  # checkpoint stage boundaries into graph_folder
    mesh: str = "auto"  # "auto": shard graph build over all devices; "off": single-device

    def get_timestamp(self) -> str:
        return datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")

    def input_file_list(self) -> list[str]:
        return [f for f in self.input_files.split(" ") if f]

    def fastq_files(self) -> tuple[str, Optional[str]]:
        """Split input_files like reference src/tmp_utils.cpp:8-24."""
        files = self.input_file_list()
        if len(files) >= 2:
            return files[0], files[1]
        return self.input_files, None

    # -- validation (reference include/settings.h:72-116) --------------------

    def validate_settings(self) -> dict[str, tuple[bool, str]]:
        out: dict[str, tuple[bool, str]] = {}
        input_valid = bool(self.input_files)
        out["Input Files"] = (
            input_valid,
            f"{self.input_files} exist(s)" if input_valid else "No input files specified",
        )
        ram_str = f"{self.ram:.2f}"
        ram_valid = self.ram > 1.0
        out["RAM"] = (
            ram_valid,
            f"{ram_str} GB" if ram_valid
            else f"Value {ram_str} GB is invalid (must be greater than 1 GB)",
        )
        max_t = os.cpu_count() or 1
        threads_valid = 0 < self.threads <= max_t
        out["Threads"] = (
            threads_valid,
            f"{self.threads} thread(s)" if threads_valid
            else f"Value {self.threads} is invalid (must be between 1 and {max_t})",
        )
        output_valid = bool(self.output_folder)
        out["Output Folder"] = (
            output_valid, self.output_folder if output_valid else "Invalid output folder"
        )
        return out

    def print_settings(self) -> str:
        erroneous = ""
        for key, (ok, msg) in self.validate_settings().items():
            mark = "[✔]" if ok else "[✗]"
            print(f"{mark} {key}: {msg}")
            if not ok:
                erroneous += key + " "
        return erroneous

    # -- settings file loader (reference include/settings.h:127-220) ---------

    def load_from_file(self, path: str) -> bool:
        try:
            fh = open(path, "r")
        except OSError:
            print(f"Could not open settings file: {path}")
            return False
        with fh:
            for line in fh:
                # strip comments (# and //)
                if "#" in line:
                    line = line[: line.index("#")]
                if "//" in line:
                    line = line[: line.index("//")]
                s = line.strip()
                if not s or "=" not in s:
                    continue
                key, _, val = s.partition("=")
                key = key.strip()
                val = val.strip()
                self._apply_kv(key, val)
        return True

    def _apply_kv(self, key: str, val: str) -> None:
        cfs = self.cycle_finder_settings
        dss = self.dna_sequence_settings
        if key == "input_files":
            # comma/semicolon tolerant, normalized to single-space separated
            tokens = val.replace(",", " ").replace(";", " ").split()
            self.input_files = " ".join(tokens)
        elif key == "ram":
            self.ram_explicit = True
            try:
                self.ram = parse_ram_to_gb(val)
            except ValueError:
                print(f"Warning: could not parse RAM value '{val}' in settings file")
        elif key == "threads":
            try:
                self.threads = int(val)
            except ValueError:
                pass
        elif key == "output_folder":
            self.output_folder = val
        elif key == "graph_folder":
            self.graph_folder = val
        elif key == "cycles_folder":
            self.cycles_folder = val
        elif key == "output_file":
            self.output_file = val
        elif key == "cycle_max_length":
            cfs.cycle_max_length = int(val)
        elif key == "cycle_min_length":
            cfs.cycle_min_length = int(val)
        elif key == "threshold_multiplicity":
            cfs.threshold_multiplicity = int(val)
        elif key == "low_abundance":
            cfs.low_abundance = val.lower() in ("true", "1", "yes")
        elif key == "spacer_min_length":
            dss.spacer_min_length = int(val)
        elif key == "spacer_max_length":
            dss.spacer_max_length = int(val)
        elif key == "repeat_min_length":
            dss.repeat_min_length = int(val)
        elif key == "repeat_max_length":
            dss.repeat_max_length = int(val)
        elif key == "mesh":
            self.mesh = val
        # unknown keys ignored for forward-compatibility


def parse_ram_to_gb(ram_input: str) -> float:
    """Parse '4G' / '500M' / plain GB float. Reference src/main.cpp:144-165."""
    s = ram_input.strip()
    idx = len(s)
    for i, c in enumerate(s):
        if c not in "0123456789.":
            idx = i
            break
    if idx == len(s):
        return float(s)
    value = float(s[:idx])
    unit = s[idx].upper()
    if unit == "B":
        return value / (1024.0**3)
    if unit == "K":
        return value / (1024.0**2)
    if unit == "M":
        return value / 1024.0
    if unit == "G":
        return value
    raise ValueError("Error: Invalid RAM unit. Use B, K, M, or G.")


def get_total_system_ram_gb() -> float:
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        return pages * page_size / (1024.0**3)
    except (ValueError, OSError):
        return 0.0
