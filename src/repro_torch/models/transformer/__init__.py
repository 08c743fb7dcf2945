"""The decoder-only transformer family of the port (gemma2, qwen1.5,
tinyllama, moonshot, arctic): rotary embeddings (``rope``), chunked and
decode attention (``attention``), the MoE FFN (``moe``) and the model
with its serve paths (``model``)."""
