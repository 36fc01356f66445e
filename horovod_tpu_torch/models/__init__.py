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
from horovod_tpu_torch.models.vgg import (VGG, VGG11, VGG13, VGG16, VGG19,
                                          load_flax_vgg)
from horovod_tpu_torch.models.inception import (InceptionV3,
                                                load_flax_inception)
from horovod_tpu_torch.models.t5 import (T5, T5Config, load_flax_t5,
                                         t5_beam_decode, t5_generate,
                                         t5_greedy_decode)
from horovod_tpu_torch.models.generate import (beam_reorder_cache,
                                               beam_search, generate,
                                               init_decode_cache,
                                               prefill_prefix)
from horovod_tpu_torch.models.gpt import cache_from_flax, cache_to_numpy
from horovod_tpu_torch.models.lora import (adapter_loss_fn,
                                           adapter_loss_fn_via_extra,
                                           lora_apply, lora_init, lora_merge,
                                           lora_wire_numbers)
from horovod_tpu_torch.models.speculative import (rewind_cache,
                                                  speculative_accept,
                                                  speculative_generate)

__all__ += ["VGG", "VGG11", "VGG13", "VGG16", "VGG19", "load_flax_vgg",
            "InceptionV3", "load_flax_inception", "T5", "T5Config",
            "load_flax_t5", "t5_beam_decode", "t5_generate",
            "t5_greedy_decode", "beam_search", "generate", "prefill_prefix",
            "init_decode_cache", "beam_reorder_cache", "rewind_cache",
            "cache_from_flax", "cache_to_numpy",
            "adapter_loss_fn", "adapter_loss_fn_via_extra", "lora_apply",
            "lora_init", "lora_merge", "lora_wire_numbers",
            "speculative_accept", "speculative_generate"]
