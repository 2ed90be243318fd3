from repro_torch.data.clickstream import ClickStream, make_clickstream

__all__ = ["ClickStream", "make_clickstream"]
