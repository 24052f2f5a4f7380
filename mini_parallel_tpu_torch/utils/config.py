"""Configuration: .env + environment variables, reference-compatible schema.

The same schema, fields and defaults as mini_parallel_tpu/utils/config.py,
so one .env drives both packages. Knobs the port does not use yet
(``MPT_MESH_SHAPE``, ``MPT_BATCH_PAD``, the affine gap costs) are parsed
all the same and refused where they would take effect.

The reference's config tiers (`README.md:23-33`, `main.rs:50`,
`aligner.rs:8-15,184-204,466-469`):

- ``WGS_DATA_DIR``, ``WGS_SAMPLE_ID``, ``WGS_LANES`` (default 8),
  ``WGS_READS_PER_LANE`` (default 2) — WGS file-list generation,
- ``GPU_CHUNK_SIZE_READS`` — mandatory, "the ONLY source of truth" for chunk
  size (aligner.rs:8-15). We accept it verbatim plus the hardware-neutral
  alias ``CHUNK_SIZE_READS``,
- ``USE_PINNED_MEMORY`` — accepted and ignored,
- ``GPU_CHUNK_SIZE_BASES`` — documented but never read by the reference
  (README.md:32); same here.

Knobs of the JAX package, all optional with safe defaults:
- ``MPT_READ_PAD`` — static read-length bucket (default 152; Illumina reads
  are <=151bp, and 152 is a multiple of 4, as 2-bit packing needs),
- ``MPT_BATCH_PAD`` — batch bucket rounding (default 1024, a lane multiple),
- ``MPT_MESH_SHAPE`` — e.g. "8" or "4x2" for (data, seq) axes,
- ``MPT_MODE`` — "kadane" (reference parity, default) or "sw" (true DP).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def load_dotenv(path: str = ".env", env: dict | None = None, override: bool = False) -> dict:
    """Tiny .env parser (KEY=VALUE, '#' comments); dotenv semantics: existing
    environment wins unless override=True (matches main.rs:50 dotenv crate)."""
    env = os.environ if env is None else env
    if not os.path.exists(path):
        return dict(env)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip().strip("\"'")
            if override or key not in env:
                env[key] = val
    return dict(env)


class ConfigError(ValueError):
    pass


@dataclass
class Config:
    wgs_data_dir: str = "/path/to/wgs/data"  # aligner.rs:185 default
    sample_id: str = "SAMPLE_ID"  # aligner.rs:187 default
    lanes: int = 8  # aligner.rs:189-191
    reads_per_lane: int = 2  # aligner.rs:192-195
    chunk_size_reads: int = 0  # mandatory, aligner.rs:8-15
    use_pinned_memory: bool = False  # aligner.rs:466-469 (accepted, no-op)
    read_pad: int = 152
    batch_pad: int = 1024
    mesh_shape: tuple[int, ...] = field(default_factory=tuple)
    mode: str = "kadane"  # "kadane" parity | "sw" | "sw-affine" | "contiguous"
    gap_open: int = -2  # affine mode: first gap char costs open + extend
    gap_extend: int = -1
    # 2-bit packed host->device transfer (ops/packed.py): 4x fewer wire
    # bytes, bit-exact via per-row exception lists. Off = raw uint8 ASCII
    # (the reference's representation, aligner.rs:478-499).
    packed_transfer: bool = True

    @property
    def total_files(self) -> int:
        return self.lanes * self.reads_per_lane

    def wgs_file_list(self) -> list[str]:
        """16-file list: {SAMPLE}_L{lane:03}_R{read}_001.fastq.gz
        (aligner.rs:197-204, README.md:47-49)."""
        files = []
        for lane in range(1, self.lanes + 1):
            for read in range(1, self.reads_per_lane + 1):
                name = f"{self.sample_id}_L{lane:03d}_R{read}_001.fastq.gz"
                files.append(os.path.join(self.wgs_data_dir, name))
        return files


def _int(env: dict, key: str, default: int) -> int:
    try:
        return int(env.get(key, default))
    except ValueError:
        return default  # reference uses unwrap_or(default), aligner.rs:190-195


def get_config(env: dict | None = None, require_chunk_size: bool = True) -> Config:
    env = dict(os.environ) if env is None else env
    chunk_raw = env.get("GPU_CHUNK_SIZE_READS", env.get("CHUNK_SIZE_READS"))
    if chunk_raw is None:
        if require_chunk_size:
            raise ConfigError(
                "GPU_CHUNK_SIZE_READS not set in .env file"  # aligner.rs:11
            )
        chunk = 10_000  # README.md:31 documented default
    else:
        try:
            chunk = int(chunk_raw)
        except ValueError as e:
            raise ConfigError(
                f"Invalid GPU_CHUNK_SIZE_READS value '{chunk_raw}': {e}"  # aligner.rs:14
            )
    mesh_raw = env.get("MPT_MESH_SHAPE", "")
    try:
        mesh = tuple(
            int(x) for x in
            mesh_raw.lower().replace("x", " ").replace(",", " ").split()
        ) if mesh_raw else ()
    except ValueError as e:
        raise ConfigError(
            f"Invalid MPT_MESH_SHAPE value '{mesh_raw}' (want e.g. '8' or "
            f"'4x2'): {e}"
        )
    return Config(
        wgs_data_dir=env.get("WGS_DATA_DIR", "/path/to/wgs/data"),
        sample_id=env.get("WGS_SAMPLE_ID", "SAMPLE_ID"),
        lanes=_int(env, "WGS_LANES", 8),
        reads_per_lane=_int(env, "WGS_READS_PER_LANE", 2),
        chunk_size_reads=chunk,
        use_pinned_memory=str(env.get("USE_PINNED_MEMORY", "false")).lower() == "true",
        read_pad=_int(env, "MPT_READ_PAD", 152),
        batch_pad=_int(env, "MPT_BATCH_PAD", 1024),
        mesh_shape=mesh,
        mode=env.get("MPT_MODE", "kadane"),
        gap_open=_int(env, "MPT_GAP_OPEN", -2),
        gap_extend=_int(env, "MPT_GAP_EXTEND", -1),
        packed_transfer=str(env.get("MPT_PACKED_TRANSFER", "true")).lower()
        != "false",
    )
