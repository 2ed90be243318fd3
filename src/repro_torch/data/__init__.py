from repro_torch.data.clickstream import ClickStream, make_clickstream
from repro_torch.data.lm import LMStream, make_lm_stream

__all__ = ["ClickStream", "LMStream", "make_clickstream", "make_lm_stream"]
