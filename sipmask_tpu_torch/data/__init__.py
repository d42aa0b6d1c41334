"""The COCO data pipeline of the port, in numpy: image files, resizes and
polygon fills that give cv2's numbers, the dataset, the train and test
transforms and the aspect-grouped loaders."""
