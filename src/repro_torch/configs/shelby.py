"""The paper's own system configuration: the production Shelby deployment
parameters the paid write/read path uses (``launch/cluster.py``), with the
JAX package's defaults (``repro/configs/shelby.py``).  There is no
GF-backend knob: the device of the layout picks the CUDA kernel or its
plain version."""
import dataclasses

from repro_torch.storage.blob import BlobLayout


@dataclasses.dataclass(frozen=True)
class ShelbyConfig:
    layout: BlobLayout = BlobLayout(k=10, m=6, chunkset_bytes_target=10 * 1024 * 1024)
    num_sps: int = 24
    num_dcs: int = 5  # Appendix A availability model
    racks_per_dc: int = 4
    sp_service_slots: int = 4  # concurrent disk reads per SP (FIFO queue beyond)


CONFIG = ShelbyConfig()
