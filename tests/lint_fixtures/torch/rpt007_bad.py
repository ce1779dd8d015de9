"""RPT007 fixture: an error on a kernel route hidden by a fallback."""
from repro_torch.kernels.flash_attention import _launch, flash_attention_plain


def attend(q, k, v):
    try:
        return _launch(q, k, v, True, 0, None)
    except RuntimeError:
        return flash_attention_plain(q, k, v)


def warm(lib):
    try:
        lib.repro_flash_attention(0)
    except OSError:
        pass
