"""Host helpers of the eval drivers: the xlsx writer and the visualizations."""
