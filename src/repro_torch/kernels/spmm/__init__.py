from repro_torch.kernels.spmm.halo_pull import (STREAM_CHUNK_ROWS,
                                                halo_spmm_cuda,
                                                halo_spmm_plain,
                                                halo_spmm_stream_cuda,
                                                halo_spmm_stream_plain)
from repro_torch.kernels.spmm.ops import (RESIDENT_STRIPE_MAX_BYTES,
                                          SKIP_OCCUPANCY_MAX, halo_gather,
                                          halo_spmm, select_halo_kernel,
                                          spmm)
from repro_torch.kernels.spmm.ref import halo_spmm_ref, spmm_ref
from repro_torch.kernels.spmm.spmm import spmm_cuda, spmm_plain

__all__ = ["spmm", "spmm_ref", "spmm_cuda", "spmm_plain", "halo_gather",
           "halo_spmm", "halo_spmm_ref", "halo_spmm_cuda",
           "halo_spmm_plain", "halo_spmm_stream_cuda",
           "halo_spmm_stream_plain", "select_halo_kernel",
           "STREAM_CHUNK_ROWS", "RESIDENT_STRIPE_MAX_BYTES",
           "SKIP_OCCUPANCY_MAX"]
