"""The paper's DLRM models (WDL/DFM/DCN) and the dense LM backbone."""
