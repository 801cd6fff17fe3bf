"""deepseek-v2-lite — multi-head latent attention over one 576-wide
latent row a position, 2 shared + 64 routed experts (top-6) past a
dense first layer, DeepSeek's YaRN.

[hf:deepseek-ai/DeepSeek-V2-Lite config.json]  27L d_model=2048 16H
(num_key_value_heads 16: MLA has no K/V heads to share); MLA with no
q-LoRA: kv_lora_rank 512, qk_nope_head_dim 128, qk_rope_head_dim 64,
v_head_dim 128; first_k_dense_replace 1 (layer 0 a SwiGLU of width
10944); layers 1-26: 64 routed experts of width 1408, top-6 by a
softmax router (topk_method greedy, norm_topk_prob false,
routed_scaling_factor 1), and n_shared_experts 2 (one SwiGLU of width
2 x 1408 that every token takes); rope_scaling yarn (factor 40 from
4096, beta_fast 32, beta_slow 1, mscale = mscale_all_dim = 0.707) at
rope_theta 10000 over the 64 rope dims; RMSNorm eps 1e-6; vocab 102400
(untied); 163840 positions.  15,706,484,224 parameters: served in
bfloat16 on one card.
"""
from ..models.config import ModelConfig, MoEConfig, RopeConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400,
    pattern="A",
    first_dense=1,
    kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128,
    rope_theta=10_000.0,
    rope_global=RopeConfig(theta=10_000.0, kind="yarn", factor=40.0,
                           original_max_position=4096, beta_fast=32.0,
                           beta_slow=1.0, mscale=0.707,
                           mscale_all_dim=0.707),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, dropless=True,
                  norm_topk_prob=False, d_shared=2816),
    attention_impl="pallas",
    serve_param_dtype="bfloat16",
)
