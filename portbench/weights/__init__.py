"""portbench.weights: one module a model family, named by a configuration
file's `weights` key, each with make_weights(cfg, seed, device) -> dict."""
