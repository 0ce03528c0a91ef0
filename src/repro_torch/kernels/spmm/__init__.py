from repro_torch.kernels.spmm.halo_pull import (SKIP_BLOCK_ROWS,
                                                STREAM_CHUNK_ROWS,
                                                halo_spmm_cuda,
                                                halo_spmm_plain,
                                                halo_spmm_skip_cuda,
                                                halo_spmm_skip_plain,
                                                halo_spmm_stream_cuda,
                                                halo_spmm_stream_plain)
from repro_torch.kernels.spmm.ops import (RESIDENT_STRIPE_MAX_BYTES,
                                          SKIP_OCCUPANCY_MAX, halo_gather,
                                          halo_spmm, select_halo_kernel,
                                          spmm)
from repro_torch.kernels.spmm.ref import (halo_spmm_ref, halo_spmm_skip_ref,
                                          spmm_ref)
from repro_torch.kernels.spmm.spmm import (SpmmFunction, spmm_bwd_table,
                                           spmm_bwd_table_plain,
                                           spmm_bwd_wts, spmm_bwd_wts_plain,
                                           spmm_cuda, spmm_plain)

__all__ = ["spmm", "spmm_ref", "spmm_cuda", "spmm_plain", "SpmmFunction",
           "spmm_bwd_table", "spmm_bwd_table_plain", "spmm_bwd_wts",
           "spmm_bwd_wts_plain", "halo_gather", "halo_spmm",
           "halo_spmm_ref", "halo_spmm_skip_ref", "halo_spmm_cuda",
           "halo_spmm_plain", "halo_spmm_stream_cuda",
           "halo_spmm_stream_plain", "halo_spmm_skip_cuda",
           "halo_spmm_skip_plain", "select_halo_kernel",
           "STREAM_CHUNK_ROWS", "SKIP_BLOCK_ROWS",
           "RESIDENT_STRIPE_MAX_BYTES", "SKIP_OCCUPANCY_MAX"]
