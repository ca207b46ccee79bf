"""The plain versions of the ported kernels, under the names of the JAX
package's ``repro/kernels/ref.py`` oracles. They are defined beside their
kernels; this module only names them."""
from repro_torch.kernels.block_matmul import (  # noqa: F401
    block_matmul_plain as block_matmul_ref)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    attn_core as flash_attention_ref,
    paged_attention_plain as flash_attention_paged_ref)
from repro_torch.kernels.rmsnorm import (  # noqa: F401
    rmsnorm_plain as rmsnorm_ref)
from repro_torch.kernels.selective_scan import (  # noqa: F401
    selective_scan_plain as selective_scan_ref)
