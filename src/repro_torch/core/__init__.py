"""EDM core of the port: config types, delay embedding, statistics, kNN
tables, phase 1 (simplex) and phase 2 (CCM), and the pipeline."""
