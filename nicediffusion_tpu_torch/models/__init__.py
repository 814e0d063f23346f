"""UNet epsilon predictor."""
