from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_ref,
                                                     flash_attention_tc_ref)

__all__ = ["flash_attention", "attention_ref", "flash_attention_ref",
           "flash_attention_tc_ref"]
