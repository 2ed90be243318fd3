from repro_torch.configs.recsys import (ALIMAMA_DIEN, CRITEO_DEEPFM,
                                        PRIVATE_YOUTUBEDNN, RECSYS_CONFIGS,
                                        RecsysConfig)

__all__ = ["ALIMAMA_DIEN", "CRITEO_DEEPFM", "PRIVATE_YOUTUBEDNN",
           "RECSYS_CONFIGS", "RecsysConfig"]
