from horovod_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101, ResNet152,
                                             load_flax_variables)

__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "load_flax_variables"]
from horovod_tpu_torch.models.gpt import (GPT, GPTConfig, GPTEmbed, GPTHead,
                                          load_flax_gpt)

__all__ += ["GPT", "GPTConfig", "GPTEmbed", "GPTHead", "load_flax_gpt"]
