"""The OpenAI-compatible server of the port (counterpart of
tinygpt_tpu/server)."""

from tinygpt_tpu_torch.server.http import ServerConfig, TinyGPTServer, main

__all__ = ["TinyGPTServer", "ServerConfig", "main"]
