"""The paper's own system configuration: the production Shelby deployment
parameters the paid write/read path and its DAS plane use
(``launch/cluster.py``), with the JAX package's defaults
(``repro/configs/shelby.py``).  There is no
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
    # data-availability sampling (storage/das.py): the 2-D extension's data
    # square side (k x k -> 2k x 2k shares), per-share byte size, samples a
    # light client draws per blob per epoch, the master switch, an optional
    # override of the modeled per-share proof wire size (None = the true
    # Merkle-path size), and the streaming-p99 inflation budget the bench
    # asserts under a concurrent DAS storm
    das_k: int = 4
    das_share_bytes: int = 512
    das_samples_per_epoch: int = 16
    das_extension: bool = True
    das_proof_bytes_per_share: int | None = None
    das_p99_budget: float = 1.8

    def das(self):
        """The DASSpec these knobs describe, or None when the 2-D
        extension is switched off (no dispersal, no sampling plane)."""
        from repro_torch.storage.das import DASSpec

        if not self.das_extension:
            return None
        return DASSpec(
            k=self.das_k,
            share_bytes=self.das_share_bytes,
            samples_per_epoch=self.das_samples_per_epoch,
            extension=True,
            proof_bytes_per_share=self.das_proof_bytes_per_share,
        )


CONFIG = ShelbyConfig()
