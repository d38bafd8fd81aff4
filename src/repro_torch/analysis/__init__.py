"""Analysis at the graph layer: collective sites of captured programs,
the tuning-potential report, the rewrite mode and the roofline (the JAX
package's ``repro.analysis``, on ``torch.fx`` graphs instead of HLO
text)."""
