"""Typed pipeline configuration.

Mirrors the reference's ~22 tuning parameters with identical names and
defaults (reference: src/options.ggo:94-370, src/configuration.c:44-174).
A ``config-dump.ini`` artifact is emitted like the reference does
(configuration.c:41, 317-321) so runs are reproducible/diffable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class Config:
    # Alignment parameters (options.ggo "Parameters" section).
    min_factor_len: int = 15              # --min-factor-length
    min_intron_length: int = 40           # --min-intron-length
    max_intron_length: int = 0            # --max-intron-length (0 = unbounded)
    min_string_depth_rate: float = 0.2    # --min-string-depth-rate
    max_prefix_discarded_rate: float = 0.60   # --max-prefix-discarded-rate
    max_suffix_discarded_rate: float = 0.60   # --max-suffix-discarded-rate
    max_prefix_discarded: int = 50        # --max-prefix-discarded (nt)
    max_suffix_discarded: int = 50        # --max-suffix-discarded (nt)
    max_site_difference: int = 50         # --min-distance-of-splice-sites
    max_number_of_factorizations: int = 0  # --max-no-of-factorizations (0 = off)
    max_coverage_diff: float = 0.05       # --max-difference-of-coverage
    max_exonNUM_diff: int = 5             # --max-difference-of-no-of-exons
    max_gapLength_diff: int = 20          # --max-difference-of-gap-length
    complexity_threshold: float = 20.0    # --complexity-threshold (dust)
    retain_externals: bool = True         # --retain-externals
    max_pairings_in_MEG: int = 80         # --max-pairings-in-CMEG
    max_freq_shortest_pairing: float = 0.4  # --max-shortest-pairing-frequence
    suffpref_length_for_intron: int = 70  # --suff-pref-length-intron
    suffpref_length_on_est: int = 30      # --suff-pref-length-est
    suffpref_length_on_gen: int = 30      # --suff-pref-length-genomic
    trans_red: bool = True                # not --no-transitive-reduction
    short_edge_comp: bool = True          # not --no-short-edge-compaction
    max_single_factorization_time: int = 900  # --max-single-factorization-time (s)

    def validate(self) -> "Config":
        """Range checks mirroring configuration.c:check_and_copy."""
        assert self.min_factor_len > 0
        assert self.min_intron_length >= 0
        assert self.max_intron_length >= 0
        assert 0.0 <= self.min_string_depth_rate <= 1.0
        assert 0.0 <= self.max_prefix_discarded_rate <= 1.0
        assert 0.0 <= self.max_suffix_discarded_rate <= 1.0
        assert self.max_prefix_discarded >= 0
        assert self.max_suffix_discarded >= 0
        assert self.max_site_difference >= 0
        assert self.max_number_of_factorizations >= 0
        assert 0.0 <= self.max_coverage_diff <= 1.0
        assert self.max_exonNUM_diff >= -1
        assert self.max_gapLength_diff >= -1
        assert self.complexity_threshold > 0.0
        assert self.max_pairings_in_MEG >= 0
        assert 0.0 <= self.max_freq_shortest_pairing <= 1.0
        assert self.suffpref_length_for_intron > 0
        assert self.suffpref_length_on_est > 0
        assert self.suffpref_length_on_gen > 0
        assert self.max_single_factorization_time >= 0
        return self

    def clone(self) -> "Config":
        """Per-EST mutable copy (configuration.c:config_clone); the retry
        ladder bumps min_factor_len on the clone only."""
        return dataclasses.replace(self)

    # --- INI round-trip (gengetopt-compatible names) -----------------------

    _INI_NAMES = {
        "min-factor-length": ("min_factor_len", int),
        "min-intron-length": ("min_intron_length", int),
        "max-intron-length": ("max_intron_length", int),
        "min-string-depth-rate": ("min_string_depth_rate", float),
        "max-prefix-discarded-rate": ("max_prefix_discarded_rate", float),
        "max-suffix-discarded-rate": ("max_suffix_discarded_rate", float),
        "max-prefix-discarded": ("max_prefix_discarded", int),
        "max-suffix-discarded": ("max_suffix_discarded", int),
        "min-distance-of-splice-sites": ("max_site_difference", int),
        "max-no-of-factorizations": ("max_number_of_factorizations", int),
        "max-difference-of-coverage": ("max_coverage_diff", float),
        "max-difference-of-no-of-exons": ("max_exonNUM_diff", int),
        "max-difference-of-gap-length": ("max_gapLength_diff", int),
        "complexity-threshold": ("complexity_threshold", float),
        "max-pairings-in-CMEG": ("max_pairings_in_MEG", int),
        "max-shortest-pairing-frequence": ("max_freq_shortest_pairing", float),
        "suff-pref-length-intron": ("suffpref_length_for_intron", int),
        "suff-pref-length-est": ("suffpref_length_on_est", int),
        "suff-pref-length-genomic": ("suffpref_length_on_gen", int),
        "max-single-factorization-time": ("max_single_factorization_time", int),
    }

    @classmethod
    def from_ini(cls, path: str) -> "Config":
        """Parse a gengetopt-style config.ini ('name value' / 'name = value')."""
        cfg = cls()
        with open(path, "r", encoding="utf-8") as f:
            for raw in f:
                line = raw.strip()
                if not line or line[0] in "#;":
                    continue
                if "=" in line:
                    name, _, value = line.partition("=")
                else:
                    parts = line.split(None, 1)
                    name, value = parts[0], (parts[1] if len(parts) > 1 else "")
                name = name.strip()
                value = value.strip().strip('"')
                if name == "retain-externals":
                    cfg.retain_externals = value != "false"
                elif name == "no-transitive-reduction":
                    cfg.trans_red = False
                elif name == "no-short-edge-compaction":
                    cfg.short_edge_comp = False
                elif name in cls._INI_NAMES:
                    field, typ = cls._INI_NAMES[name]
                    setattr(cfg, field, typ(value))
        return cfg.validate()

    def dump_ini(self, path: str = "./config-dump.ini") -> None:
        """Emit the effective configuration (configuration.c __SAVE_CONFIG_FILE__)."""
        def fmt(v):
            if isinstance(v, float):
                s = f"{v:.10f}"
                while len(s) > 1 and s.endswith("0") and not s.endswith(".0"):
                    s = s[:-1]
                return s
            return str(v)

        lines = ['config-file="config.ini"']
        for ini_name, (field, _typ) in self._INI_NAMES.items():
            lines.append(f'{ini_name}="{fmt(getattr(self, field))}"')
        lines.append('retain-externals="%s"' % ("true" if self.retain_externals else "false"))
        if not self.trans_red:
            lines.append("no-transitive-reduction")
        if not self.short_edge_comp:
            lines.append("no-short-edge-compaction")
        from pintron_tpu_torch.utils import write_text
        write_text(path, "\n".join(lines) + "\n")
