from horovod_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101, ResNet152,
                                             load_flax_variables)

__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "load_flax_variables"]
from horovod_tpu_torch.models.gpt import (GPT, GPTConfig, GPTEmbed, GPTHead,
                                          load_flax, load_flax_gpt)

__all__ += ["GPT", "GPTConfig", "GPTEmbed", "GPTHead", "load_flax",
            "load_flax_gpt"]
from horovod_tpu_torch.models.bert import (BertConfig, BertForPreTraining,
                                           BertModel, load_flax_bert)
from horovod_tpu_torch.models.llama import (Llama, LlamaBlock, LlamaConfig,
                                            load_flax_llama)
from horovod_tpu_torch.models.mlp import MLP, load_flax_mlp
from horovod_tpu_torch.models.vit import ViT, ViTConfig, load_flax_vit

__all__ += ["BertConfig", "BertModel", "BertForPreTraining", "load_flax_bert",
            "Llama", "LlamaBlock", "LlamaConfig", "load_flax_llama", "MLP",
            "load_flax_mlp", "ViT", "ViTConfig", "load_flax_vit"]
