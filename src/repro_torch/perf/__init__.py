from .hw import H100, V5E, HwSpec, kernel_bound, roofline_terms
