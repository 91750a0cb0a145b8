"""The paper's DLRM models (WDL/DFM/DCN)."""
