"""Model families ported so far: DLRM."""
