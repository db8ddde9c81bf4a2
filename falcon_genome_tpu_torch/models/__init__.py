"""Germline calling models: active regions, assembly, genotyping and the
HaplotypeCaller driver."""
