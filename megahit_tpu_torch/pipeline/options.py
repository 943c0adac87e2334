"""Pipeline options: flags, k-list logic, presets, validation.

Mirrors the reference driver's option handling (src/megahit:158-247
`Options`, :486-568 `check_and_correct_option`, :491-505 presets),
re-expressed declaratively. Counterpart of
megahit_tpu/pipeline/options.py; this port also records the device it
runs on.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


@dataclass
class Options:
    # input libraries
    pe1: list[str] = field(default_factory=list)
    pe2: list[str] = field(default_factory=list)
    pe12: list[str] = field(default_factory=list)
    se: list[str] = field(default_factory=list)
    # output
    out_dir: str = "./megahit_out"
    out_prefix: str = ""
    # k strategy (reference defaults src/megahit:170-190)
    k_list: list[int] = field(
        default_factory=lambda: [21, 29, 39, 59, 79, 99, 119, 141]
    )
    k_min: int = -1  # set from k_list
    k_max: int = -1
    k_step: int = -1
    auto_k: bool = True
    min_count: int = 2
    # graph cleaning
    prune_level: int = 2
    prune_depth: float = 2
    bubble_level: int = 2
    merge_len: int = 20
    merge_similar: float = 0.95
    disconnect_ratio: float = 0.1
    low_local_ratio: float = 0.2
    cleaning_rounds: int = 5
    max_tip_len: int = -1
    no_mercy: bool = False
    no_local: bool = False
    kmin_1pass: bool = False
    # output filtering
    min_contig_len: int = 200
    # resources (reference -m, src/megahit:165,596-609)
    memory: float = 0.9
    mem_flag: int = 1  # SdBG build memory mode (src/megahit:189)
    num_cpu_threads: int = 0  # reference -t; 0 = all logical CPUs
    device: str = "cuda"  # torch device of the count and graph passes
    use_mesh: bool = False  # shard counting, build sorts and cleaning
    # misc
    temp_dir: str = ""  # reference --tmp-dir (src/megahit:458-461)
    keep_tmp_files: bool = False
    test_mode: bool = False
    continue_mode: bool = False
    verbose: bool = False

    def apply_preset(self, preset: str) -> None:
        """Reference presets (src/megahit:491-505)."""
        # presets re-enable auto_k so the long ladder is pruned to the
        # library read length (src/megahit:492 "opt.auto_k = True")
        if preset == "meta-sensitive":
            self.min_count = 1
            self.k_list = [21, 29, 39, 49, 59, 69, 79, 89, 99, 109, 119,
                           129, 141]
            self.auto_k = True
        elif preset == "meta-large":
            self.min_count = 1
            self.k_list = [27, 37, 47, 57, 67, 77, 87, 97, 107, 117, 127]
            self.auto_k = True
        else:
            raise ValueError(f"invalid preset: {preset}")

    def validate(self) -> None:
        """k-list constraints (src/megahit:523-542)."""
        if self.k_min != -1 or self.k_max != -1 or self.k_step != -1:
            k_min = self.k_min if self.k_min != -1 else 21
            k_max = self.k_max if self.k_max != -1 else 141
            k_step = self.k_step if self.k_step != -1 else 10
            self.k_list = list(range(k_min, k_max + 1, k_step))
            if self.k_list[-1] != k_max:
                self.k_list.append(k_max)
        self.k_list = sorted(set(self.k_list))
        for k in self.k_list:
            if k < 15 or k > 255 or k % 2 == 0:
                raise ValueError(f"k must be odd, in [15, 255]; got {k}")
        for a, b in zip(self.k_list, self.k_list[1:]):
            if b - a > 28:
                raise ValueError(
                    f"k-step between {a} and {b} exceeds 28"
                )
        self.k_min = self.k_list[0]
        self.k_max = self.k_list[-1]
        if self.min_count == 1:
            # reference: min_count==1 implies 1-pass + no mercy
            # (src/megahit:540-542)
            self.kmin_1pass = True
            self.no_mercy = True
        if not (self.pe1 or self.pe2 or self.pe12 or self.se
                or self.test_mode or self.continue_mode):
            raise ValueError("no input files given (-1/-2/--12/-r)")
        if len(self.pe1) != len(self.pe2):
            raise ValueError("-1 and -2 must pair up")

    def drop_large_k(self, max_read_len: int) -> bool:
        """Drop k > max_read_len + 20 (reference set_max_k_by_lib,
        src/megahit:756-768)."""
        if not self.auto_k or len(self.k_list) == 1:
            return False
        new = [k for k in self.k_list if k < max_read_len + 20]
        if not new or new == self.k_list:
            return False
        self.k_list = new
        self.k_min, self.k_max = new[0], new[-1]
        return True

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(asdict(self), fh, indent=1)

    @classmethod
    def load(cls, path: str) -> "Options":
        with open(path) as fh:
            d = json.load(fh)
        return cls(**d)
