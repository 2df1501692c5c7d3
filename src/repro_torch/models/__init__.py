"""The port's LM side: layers and the dense decoder-only family."""
